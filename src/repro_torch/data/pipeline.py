"""Deterministic data pipeline with the paper's S3-style batch addressing.

A numpy copy of the reference's ``repro/data/pipeline.py``: for the same
dataset seed and ``BatchKey`` it yields bit-identical batches.

The paper preprocesses the dataset, partitions it per peer, splits each
partition into batches and uploads every batch to S3 under a key the Lambda
workers fetch. We reproduce the *addressing scheme* — every batch is
reachable by ``BatchKey(peer, epoch, index)`` and is a pure function of
(dataset seed, key) — with procedural datasets, since the container is
offline:

* ``mnist`` / ``cifar`` — class-template images + Gaussian noise, matching
  the shapes/statistics of the real datasets (28x28x1 / 32x32x3, 10 classes,
  60k train). Learnable by the paper's CNNs in a few hundred steps.
* ``lm`` — synthetic token streams with learnable bigram structure for the
  transformer architectures.

Preprocessing (min-max scaling / standardization / normalization, paper
§III-B.1) is applied at generation time.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclass(frozen=True)
class BatchKey:
    """The S3-object analogue: uniquely addresses one batch."""

    peer: int
    epoch: int
    index: int

    def s3_key(self, dataset: str) -> str:
        return f"{dataset}/peer={self.peer}/epoch={self.epoch}/batch={self.index:05d}.npz"


@dataclass(frozen=True)
class Dataset:
    name: str
    kind: str  # "image" | "lm"
    size: int
    image_hw: int = 0
    channels: int = 0
    num_classes: int = 0
    vocab_size: int = 0
    seq_len: int = 0
    seed: int = 0
    preprocessing: str = "standardize"  # minmax | standardize | none


def make_dataset(name: str, **overrides) -> Dataset:
    presets = {
        "mnist": Dataset("mnist", "image", 60_000, image_hw=28, channels=1, num_classes=10),
        "cifar": Dataset("cifar", "image", 60_000, image_hw=32, channels=3, num_classes=10),
        "lm": Dataset("lm", "lm", 1_000_000, vocab_size=512, seq_len=128),
    }
    if name not in presets:
        raise KeyError(f"unknown dataset {name!r}")
    return dataclasses.replace(presets[name], **overrides)


# ---------------------------------------------------------------------------
# Procedural sample generation
# ---------------------------------------------------------------------------


def _class_templates(ds: Dataset) -> np.ndarray:
    rng = np.random.default_rng(ds.seed + 7)
    t = rng.normal(0, 1, (ds.num_classes, ds.image_hw, ds.image_hw, ds.channels))
    # smooth templates so they have low-frequency, learnable structure
    for _ in range(2):
        t = 0.5 * t + 0.125 * (
            np.roll(t, 1, 1) + np.roll(t, -1, 1) + np.roll(t, 1, 2) + np.roll(t, -1, 2)
        )
    # renormalize to unit per-template std so the class signal survives noise
    t = t / (t.std(axis=(1, 2, 3), keepdims=True) + 1e-9)
    return t.astype(np.float32)


_TEMPLATE_CACHE: Dict[Tuple, np.ndarray] = {}


def generate_images(ds: Dataset, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pure function of (dataset, indices) -> (images, labels)."""
    ck = (ds.name, ds.seed, ds.image_hw, ds.channels, ds.num_classes)
    if ck not in _TEMPLATE_CACHE:
        _TEMPLATE_CACHE[ck] = _class_templates(ds)
    templates = _TEMPLATE_CACHE[ck]
    labels = (indices * 2654435761 % ds.num_classes).astype(np.int32)
    imgs = np.empty((len(indices), ds.image_hw, ds.image_hw, ds.channels), np.float32)
    for i, (idx, lab) in enumerate(zip(indices, labels)):
        rng = np.random.default_rng(ds.seed * 1_000_003 + int(idx))
        imgs[i] = templates[lab] + rng.normal(0, 0.5, templates[lab].shape)
    if ds.preprocessing == "minmax":
        lo, hi = imgs.min(), imgs.max()
        imgs = (imgs - lo) / max(hi - lo, 1e-9)
    elif ds.preprocessing == "standardize":
        imgs = (imgs - imgs.mean()) / max(imgs.std(), 1e-9)
    return imgs, labels


def generate_tokens(ds: Dataset, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic LM sequences with a fixed random bigram transition table."""
    rng0 = np.random.default_rng(ds.seed + 13)
    # sparse deterministic "grammar": each token has 4 likely successors
    succ = rng0.integers(0, ds.vocab_size, (ds.vocab_size, 4))
    toks = np.empty((len(indices), ds.seq_len + 1), np.int32)
    for i, idx in enumerate(indices):
        rng = np.random.default_rng(ds.seed * 999_983 + int(idx))
        seq = np.empty(ds.seq_len + 1, np.int32)
        seq[0] = rng.integers(0, ds.vocab_size)
        choices = rng.integers(0, 4, ds.seq_len)
        noise = rng.random(ds.seq_len) < 0.1
        rand_toks = rng.integers(0, ds.vocab_size, ds.seq_len)
        for t in range(ds.seq_len):
            seq[t + 1] = rand_toks[t] if noise[t] else succ[seq[t], choices[t]]
        toks[i] = seq
    return toks[:, :-1], toks[:, 1:]


# ---------------------------------------------------------------------------
# Partitioning & loading (paper §III-B.1)
# ---------------------------------------------------------------------------


class Partitioner:
    """Disjoint, exhaustive split of the dataset across P peers."""

    def __init__(self, ds: Dataset, num_peers: int, *, shuffle_seed: int = 0):
        self.ds = ds
        self.num_peers = num_peers
        rng = np.random.default_rng(shuffle_seed)
        self._perm = rng.permutation(ds.size)

    def partition(self, peer: int) -> np.ndarray:
        if not (0 <= peer < self.num_peers):
            raise IndexError(peer)
        per = self.ds.size // self.num_peers
        return self._perm[peer * per : (peer + 1) * per]


class DataLoader:
    """Batches one peer's partition; every batch addressable by BatchKey."""

    def __init__(
        self,
        partitioner: Partitioner,
        peer: int,
        batch_size: int,
        *,
        drop_remainder: bool = True,
    ):
        self.part = partitioner.partition(peer)
        self.ds = partitioner.ds
        self.peer = peer
        self.batch_size = batch_size
        self.num_batches = (
            len(self.part) // batch_size
            if drop_remainder
            else -(-len(self.part) // batch_size)
        )

    def batch_indices(self, key: BatchKey) -> np.ndarray:
        rng = np.random.default_rng((self.ds.seed, key.peer, key.epoch))
        order = rng.permutation(len(self.part))
        sel = order[key.index * self.batch_size : (key.index + 1) * self.batch_size]
        return self.part[sel]

    def load(self, key: BatchKey) -> Dict[str, np.ndarray]:
        idx = self.batch_indices(key)
        if self.ds.kind == "image":
            x, y = generate_images(self.ds, idx)
            return {"images": x, "labels": y}
        x, y = generate_tokens(self.ds, idx)
        return {"tokens": x, "labels": y}

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(self.num_batches):
            yield self.load(BatchKey(self.peer, epoch, i))
