"""Local P2P cluster — a literal, runnable Algorithm 1, on the card.

The port of the reference's ``repro/core/simulate.py`` sync path. P peers
run in one process with real per-peer models, optimizers, data partitions
and gradient mailboxes: each peer computes per-batch gradients with
autograd, averages them, publishes them through an ``ExchangeProtocol``,
waits at the barrier, consumes its overlay neighbours' gradients, mixes
them and steps its optimizer.

Everything runs on ``device``, by default ``"cuda"``; without a card the
cluster raises unless the caller passes ``device="cpu"``. Stage timings
synchronise the card where the reference waits for JAX's asynchronous
dispatch, so a stage's time includes the device work it queued.

Not ported yet, each refused with ``NotImplementedError`` naming its
ROADMAP item: async epochs, the serverless or instance executor, the
adversary model, ``reject_nonfinite`` and the trace recorder.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import jax_order
from repro_torch.core import compression as C
from repro_torch.core.convergence import ConvergenceDetector
from repro_torch.core.events import LinkModel
from repro_torch.core.exchange import (
    ExchangeContext,
    ExchangeProtocol,
    check_overlay,
    get_exchange,
)
from repro_torch.core.graph import PeerGraph, get_graph
from repro_torch.core.mailbox import HostMailbox
from repro_torch.data import BatchKey, DataLoader, Dataset, Partitioner
from repro_torch.metrics import StageMetrics
from repro_torch.optim import Optimizer, apply_updates

Params = Dict[str, torch.Tensor]

_ACCOUNTING = "Serverless and instance accounting"
ROBUST = "Robust, sharded and tree exchange"


def unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md, Queue 1, '{item}'"
    )


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' to run on the CPU"
        )
    return device


def cnn_loss(model, params: Params, images: torch.Tensor, labels: torch.Tensor):
    logits = functional_call(model, params, (images,))
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    loss = -logp.gather(1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return loss, acc


@dataclass
class PeerState:
    rank: int
    params: Params
    opt_state: Any
    loader: DataLoader
    metrics: StageMetrics
    steps_done: int = 0
    comm_bytes_sent: int = 0
    send_time_s: float = 0.0
    recv_time_s: float = 0.0
    compute_time_s: float = 0.0
    ef: Optional[Params] = None  # EF-SGD residual (lazily zero-init on first publish)


class LocalP2PCluster:
    """P peers, real compute, mailbox exchange, sync epochs on ``device``."""

    def __init__(
        self,
        cfg: ModelConfig,
        dataset: Dataset,
        *,
        num_peers: int,
        batch_size: int,
        batches_per_epoch: int,
        optimizer: Optimizer,
        lr: float = 0.001,
        sync: bool = True,
        executor: Any = None,
        exchange: Optional[str] = None,  # registered protocol name
        graph: Any = "full",  # peer overlay: registered name or PeerGraph
        graph_seed: Optional[int] = None,  # defaults to `seed`
        qsgd: Optional[C.QSGDConfig] = None,
        topk_frac: float = 0.01,
        ef: bool = False,  # EF-SGD residual feedback for lossy codecs
        network_bandwidth_bps: float = 1e9,  # simulated inter-peer link
        adversary: Any = None,
        reject_nonfinite: bool = False,
        tracer: Any = None,
        init_params: Optional[Mapping[str, torch.Tensor]] = None,  # e.g. convert.from_jax(...)
        seed: int = 0,
        device: Any = "cuda",
    ):
        if not sync:
            raise unported("async epochs (sync=False)", _ACCOUNTING)
        if executor is not None:
            raise unported("the serverless / instance executor", _ACCOUNTING)
        if tracer is not None:
            raise unported("the trace recorder", _ACCOUNTING)
        if adversary is not None:
            raise unported("the adversary model", ROBUST)
        if reject_nonfinite:
            raise unported("reject_nonfinite", ROBUST)
        self.device = resolve_device(device)

        if cfg.family == "cnn" and dataset.kind == "image":
            cfg = dataclasses.replace(
                cfg,
                image_size=dataset.image_hw,
                image_channels=dataset.channels,
                num_classes=dataset.num_classes,
            )
        self.cfg = cfg
        self.dataset = dataset
        self.num_peers = num_peers
        self.batches_per_epoch = batches_per_epoch
        self.optimizer = optimizer
        if exchange is None:
            exchange = "qsgd" if qsgd is not None else "allgather_mean"
        self.protocol: ExchangeProtocol = get_exchange(exchange)
        self.graph: PeerGraph = get_graph(
            graph, num_peers, seed=seed if graph_seed is None else graph_seed
        )
        self._mixing = (
            None if (self.graph.is_full or num_peers <= 1)
            else self.graph.mixing_matrix()
        )
        check_overlay(self.protocol, self.graph)
        self.ef = bool(ef)
        self.xctx = ExchangeContext(
            num_peers=num_peers, qsgd=qsgd, topk_frac=topk_frac, graph=self.graph,
            mixing=self._mixing,
        )
        self.link = LinkModel(bandwidth_bps=network_bandwidth_bps)
        self.mailbox = HostMailbox(num_peers, graph=self.graph)
        self.detector = ConvergenceDetector(lr, mode="max", max_epochs=10_000)
        # One generator on the device for all of the cluster's randomness:
        # the model's init (replaced by init_params when given), then the
        # QSGD uniforms.
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        part = Partitioner(dataset, num_peers, shuffle_seed=seed)
        self.model = models.init_model(cfg, generator=self.generator, device=self.device)
        self.model.requires_grad_(False)  # a template: peers own the parameters
        if init_params is None:
            init_params = dict(self.model.named_parameters())
        # every parameter dict of the cluster holds its leaves in JAX order
        self.names = jax_order(init_params)
        init_params = {k: init_params[k].to(self.device, torch.float32) for k in self.names}
        self.peers: List[PeerState] = []
        for r in range(num_peers):
            params = {k: init_params[k].clone() for k in self.names}
            self.peers.append(
                PeerState(
                    rank=r,
                    params=params,
                    opt_state=optimizer.init(params),
                    loader=DataLoader(part, r, batch_size),
                    metrics=StageMetrics(),
                )
            )

        # Warm up (cuDNN plans, the codec's kernels) so stage timings measure
        # compute, not set-up.
        self.protocol.prepare(self.device)
        wb = self._to_device(self.peers[0].loader.load(BatchKey(0, 0, 0)))
        g0, _, _ = self._grad(init_params, wb)
        self._apply(init_params, self.peers[0].opt_state, g0, lr)
        self._eval(init_params, wb)
        self._sync()

    # ------------------------------------------------------------------
    def _sync(self) -> None:
        """Wait for the device: the reference's ``jax.block_until_ready``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor]:
        images = models.images_to_device(batch["images"], self.device)
        labels = torch.from_numpy(batch["labels"].astype(np.int64)).to(self.device)
        return images, labels

    def _grad(self, params: Params, batch):
        leaves = {k: params[k].detach().requires_grad_(True) for k in self.names}
        with torch.enable_grad():
            loss, acc = cnn_loss(self.model, leaves, *batch)
            grads = torch.autograd.grad(loss, [leaves[k] for k in self.names])
        return dict(zip(self.names, grads)), loss.detach(), acc

    def _apply(self, params: Params, opt_state, avg_grads: Params, lr: float):
        with torch.no_grad():
            upd, opt_state = self.optimizer.update(avg_grads, opt_state, params, lr)
            return apply_updates(params, upd), opt_state

    def _eval(self, params: Params, batch):
        with torch.no_grad():
            loss, acc = cnn_loss(self.model, params, *batch)
        return loss, acc

    def _compute_peer_gradient(self, peer: PeerState, epoch: int):
        """ComputeBatchGradients + AverageBatchesGradients (Algorithm 1)."""
        batches = [
            self._to_device(peer.loader.load(BatchKey(peer.rank, epoch, i % peer.loader.num_batches)))
            for i in range(self.batches_per_epoch)
        ]
        t0 = time.perf_counter()
        outs = [self._grad(peer.params, b) for b in batches]
        gs = [o[0] for o in outs]
        with torch.no_grad():
            g = {k: sum(x[k].to(torch.float32) for x in gs) / len(gs) for k in self.names}
        loss = float(np.mean([float(o[1]) for o in outs]))
        acc = float(np.mean([float(o[2]) for o in outs]))
        compute_wall = time.perf_counter() - t0
        peer.compute_time_s += compute_wall
        return g, loss, acc, compute_wall

    def _publish(self, peer: PeerState, grads: Params, epoch: int, at_time: float):
        """SendGradientsToMyQueue via the exchange protocol's wire format.

        Returns this peer's OWN contribution for the consume/update phase:
        the raw gradient normally, or — under error feedback — the decoded
        image of the encoded payload, with the residual (what the codec
        dropped) accumulated into ``peer.ef`` for re-injection next step.
        """
        if self.ef:
            if peer.ef is None:
                peer.ef = {k: torch.zeros_like(grads[k], dtype=torch.float32) for k in self.names}
            grads = {k: grads[k].to(torch.float32) + peer.ef[k] for k in self.names}
        own = grads
        with peer.metrics.stage("send_gradients"):
            gen = self.generator if self.protocol.requires_key else None
            payload, nbytes = self.protocol.host_encode(grads, self.xctx, generator=gen)
            if self.ef:
                image = self.protocol.host_decode(payload, grads, self.xctx)
                peer.ef = {k: grads[k] - image[k].to(torch.float32) for k in self.names}
                own = image
            msg = (self.protocol.name, payload)
            self._sync()
            wire_s = self.link.transfer_s(nbytes)
            self.mailbox.publish(
                peer.rank, msg, nbytes=nbytes, time=at_time + wire_s, epoch=epoch,
            )
        peer.comm_bytes_sent += nbytes
        peer.send_time_s += wire_s
        return own

    def _consume_all(self, peer: PeerState, own_grads: Params):
        """ConsumeGradientsFromQueue along the peer's overlay edges.

        Returns ``[(rank, gradient), ...]``: the peer's own contribution
        first, then each neighbour's decoded gradient in ascending rank, the
        order in which the reference sums them."""
        contribs = [(peer.rank, own_grads)]
        with peer.metrics.stage("receive_gradients"):
            for other in self.graph.neighbors(peer.rank):
                msg = self.mailbox.consume(other, consumer=peer.rank)
                if msg is None:
                    continue
                _, payload = msg.payload
                decoded = self.protocol.host_decode(payload, own_grads, self.xctx)
                peer.recv_time_s += self.mailbox.download_time_s(msg, link=self.link)
                contribs.append((other, decoded))
        return contribs

    def _update(self, peer: PeerState, contribs, lr: float):
        """Mix the consumed gradients and step the peer's optimizer.

        Full graph: plain mean over contributions. Sparse graph:
        Metropolis–Hastings weights ``W[r]``, renormalized over the
        contributions that arrived.
        """
        with peer.metrics.stage("model_update"), torch.no_grad():
            if self._mixing is None:
                n = len(contribs)
                avg = {k: sum(g[k].to(torch.float32) for _, g in contribs) / n for k in self.names}
            else:
                w = self.graph.mixing_row(peer.rank)
                ranked = sorted(contribs, key=lambda c: c[0])
                total = float(sum(w[j] for j, _ in ranked))
                avg = {
                    k: sum(float(w[j]) * g[k].to(torch.float32) for j, g in ranked) / total
                    for k in self.names
                }
            self._apply_avg(peer, avg, lr)

    def _apply_avg(self, peer: PeerState, avg: Params, lr: float):
        """Step the peer's optimizer with an already-mixed gradient."""
        peer.params, peer.opt_state = self._apply(peer.params, peer.opt_state, avg, lr)
        self._sync()
        peer.steps_done += 1

    def evaluate(self, peer_rank: int = 0, *, num_batches: int = 2, epoch: int = 10_000):
        peer = self.peers[peer_rank]
        accs, losses = [], []
        with peer.metrics.stage("convergence_detection"):
            for i in range(num_batches):
                b = self._to_device(peer.loader.load(BatchKey(peer.rank, epoch, i)))
                loss, acc = self._eval(peer.params, b)
                losses.append(float(loss))
                accs.append(float(acc))
        return float(np.mean(losses)), float(np.mean(accs))

    # ------------------------------------------------------------------
    def run_epoch_sync(self, epoch: int) -> Dict[str, float]:
        """One synchronous epoch: compute -> publish -> barrier -> consume -> update."""
        grads, stats = {}, []
        for peer in self.peers:
            with peer.metrics.stage("compute_gradients"):
                g, loss, acc, _ = self._compute_peer_gradient(peer, epoch)
            stats.append((loss, acc))
            # own contribution for the update phase: the decoded image of
            # the published payload under EF, the raw gradient else
            grads[peer.rank] = self._publish(peer, g, epoch, at_time=0.0)
            self.mailbox.barrier_signal(peer.rank, epoch)
        if not self.mailbox.barrier_complete(epoch):  # SynchronisationBarrier
            raise RuntimeError(
                f"synchronisation barrier incomplete for epoch {epoch}: not "
                f"every peer signalled completion before the consume phase"
            )
        self.mailbox.barrier_reset(epoch)
        for peer in self.peers:
            contribs = self._consume_all(peer, grads[peer.rank])
            self._update(peer, contribs, self.detector.lr)
        loss = float(np.mean([s[0] for s in stats]))
        acc = float(np.mean([s[1] for s in stats]))
        return {"loss": loss, "acc": acc}

    def run(self, epochs: int, *, eval_every: int = 1) -> List[Dict[str, float]]:
        history = []
        for e in range(epochs):
            rec = self.run_epoch_sync(e)
            if (e + 1) % eval_every == 0:
                vloss, vacc = self.evaluate(epoch=10_000 + e)
                rec.update(val_loss=vloss, val_acc=vacc)
                if self.detector.step(vacc):
                    history.append({**rec, "epoch": e, "converged": True})
                    break
            history.append({**rec, "epoch": e})
        return history
