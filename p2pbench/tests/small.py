"""Cells of the benchmark at sizes a CPU test run holds, and faults planted
in the program underneath ``P2PTrainer.step``."""
import contextlib
import copy
import json
import time

import torch

from p2pbench import harness
from p2pbench.reference.p2p import wire_order

TINY_LM = dict(num_layers=8, d_model=128, vocab_size=500, ssm_state=32, ssm_headdim=32, ssm_chunk=16)
SEED = 2**31 + 7  # more than 32 signed bits hold


def cell(name: str, **traffic):
    """(manifest, cell, config) of the cell ``name``; an LM shrunk to
    ``TINY_LM`` at 48 tokens (three chunks), float32; 2 rows a peer; then
    ``traffic`` over the cell's own."""
    manifest, data, config = harness.load_cell(name)
    data, config = copy.deepcopy(data), copy.deepcopy(config)
    if config["family"] == "lm":
        config["model"].update(TINY_LM, dtype="float32")
        data["seq_len"] = 48
    data["rows_per_peer"] = 2
    data.update(traffic)
    return manifest, data, config


def run(name, data, config, manifest):
    """One run of the cell on the CPU, its window one step long."""
    return harness.run_cell(name, data, config, manifest, seed=SEED, seconds=0, trace=False,
                            device="cpu", t0=time.perf_counter())


@contextlib.contextmanager
def reference_once():
    """``harness.reference_readings`` computed once for each (cell, seed):
    the reference reads nothing of the program, so a fault planted there
    leaves it as it was."""
    cache, reference = {}, harness.reference_readings

    def readings(fam, config, cell, seed, device, **kw):
        key = (json.dumps([config, cell], sort_keys=True), seed, json.dumps(kw, sort_keys=True))
        if key not in cache:
            cache[key] = reference(fam, config, cell, seed, device, **kw)
        return cache[key]

    saved, harness.reference_readings = harness.reference_readings, readings
    try:
        yield
    finally:
        harness.reference_readings = saved


@contextlib.contextmanager
def planted(fault: str, monkeypatch):
    """The program's step with ``fault``: ``"unchanged"`` (the update
    returns the params and optimizer state as they were), ``"half_batch"``
    (each peer's first half of rows, or of a lone row's tokens),
    ``"no_exchange"`` (each peer keeps its own gradient: the exchange's
    combine returns the peers' own images; where the step has no exchange
    to break, the plain mean's one gradient, every peer's rows are peer
    0's), ``"altered"`` (one leaf's mixed gradient scaled by 1.5 where the
    optimizer gets it)."""
    from repro_torch.core import exchange, p2p
    from repro_torch.train.trainer import P2PTrainer

    update = p2p._update_by_leaf
    step = P2PTrainer.step

    def rows_of(batch, peers, fn):
        return {k: fn(v.reshape(peers, -1, *v.shape[1:])) for k, v in batch.items()}

    if fault == "unchanged":
        monkeypatch.setattr(p2p, "_update_by_leaf",
                            lambda opt, grads, state, params, lr, donate=False: (dict(params), state))
    elif fault == "half_batch":
        def half(v):
            dim = 1 if v.shape[1] > 1 else 2
            return v.narrow(dim, 0, v.shape[dim] // 2).flatten(0, 1)
        monkeypatch.setattr(P2PTrainer, "step", lambda self, state, batch: step(
            self, state, rows_of(batch, self.num_peers, half)))
    elif fault == "no_exchange":
        def own(cls):
            combine, combine_ef = cls.combine, cls.combine_ef
            monkeypatch.setattr(cls, "combine", lambda self, g, ctx, **kw: (
                {k: v.to(torch.float32) for k, v in g.items()}, combine(self, g, ctx, **kw)[1]))

            def ef(self, g, ctx, **kw):
                _, local, state = combine_ef(self, g, ctx, **kw)
                return {k: v.to(torch.float32) for k, v in local.items()}, local, state
            monkeypatch.setattr(cls, "combine_ef", ef)
        for cls in (exchange.AllGatherMean, exchange.QSGDExchange, exchange.TopKExchange):
            own(cls)

        def fused(self, state, batch):
            if self.topo.exchange == "allgather_mean" and not self.topo.ef:
                batch = rows_of(batch, self.num_peers, lambda v: v[:1].expand(v.shape).flatten(0, 1))
            return step(self, state, batch)
        monkeypatch.setattr(P2PTrainer, "step", fused)
    elif fault == "altered":
        def altered(opt, grads, state, params, lr, donate=False):
            k = wire_order(grads)[len(grads) // 2]
            grads[k] = grads[k] * 1.5
            return update(opt, grads, state, params, lr, donate)
        monkeypatch.setattr(p2p, "_update_by_leaf", altered)
    else:
        raise ValueError(fault)
    yield
