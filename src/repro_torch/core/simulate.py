"""Local P2P cluster — a literal, runnable Algorithm 1, on the card.

The port of the reference's ``repro/core/simulate.py``. P peers run in one
process with real per-peer models, optimizers, data partitions and
gradient mailboxes: each peer computes per-batch gradients with autograd
(optionally through a :class:`~repro_torch.core.serverless.ServerlessExecutor`,
which times each batch and prices the fan-out), averages them, publishes
them through an ``ExchangeProtocol``, consumes its overlay neighbours'
gradients, mixes them and steps its optimizer.

Synchronous epochs run in lockstep behind the mailbox barrier.
Asynchronous epochs run on the :class:`~repro_torch.core.events.EventEngine`:
each peer advances its own virtual clock by its compute time x speed,
publishes at completion instants and consumes whatever its neighbours have
published by its own clock; with churn a peer can drop mid-step, lose its
partial work and rejoin after a downtime. Churn draws from one seeded
numpy stream, as the reference's does, so a run with ``sim_compute_s``
pinned repeats the reference's event trace exactly.

Robust aggregation and the adversary model ride the same publish and
consume path: a seeded :class:`~repro_torch.core.robust.AdversarySpec`
poisons its attackers' publishes (``sign_flip``, ``scaled_noise``) or
replays their previous epoch's payload (``stale_replay``),
``reject_nonfinite`` drops non-finite contributions at consume, and the
robust protocols take over the mix through ``host_combine``. The sharded
protocols (``reduce_scatter``, ``tree[:k]``) run their own barriered
exchanges of shard-addressed messages, whose aggregators a serverless
executor prices (``aggregation_reports``).

Everything runs on ``device``, by default ``"cuda"``; without a card the
cluster raises unless the caller passes ``device="cpu"``. Stage timings
synchronise the card where the reference waits for JAX's asynchronous
dispatch, so a stage's time includes the device work it queued, and the
sharded aggregators' reduce times are read with the card synchronised.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import jax_order
from repro_torch.core import compression as C
from repro_torch.core.convergence import ConvergenceDetector
from repro_torch.core.cost import CommCost
from repro_torch.core.events import EventEngine, LinkModel
from repro_torch.core.exchange import (
    ExchangeContext,
    ExchangeProtocol,
    check_overlay,
    get_exchange,
)
from repro_torch.core.graph import PeerGraph, get_graph
from repro_torch.core.mailbox import HostMailbox
from repro_torch.core.robust import AdversarySpec, poison_gradients, tree_all_finite
from repro_torch.core.serverless import ExecutionReport, ServerlessExecutor
from repro_torch.data import BatchKey, DataLoader, Dataset, Partitioner
from repro_torch.metrics import StageMetrics
from repro_torch.optim import Optimizer, apply_updates

Params = Dict[str, torch.Tensor]


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


def _copy_payload(payload):
    """A copy of a wire payload that no later encode can write into: its
    tensors cloned, its numpy arrays copied, its containers rebuilt."""
    if torch.is_tensor(payload):
        return payload.clone()
    if isinstance(payload, np.ndarray):
        return payload.copy()
    if isinstance(payload, dict):
        return {k: _copy_payload(payload[k]) for k in list(payload)}
    if isinstance(payload, (list, tuple)):
        return type(payload)(_copy_payload(v) for v in payload)
    return payload


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
    clock: float = 0.0  # virtual time (async mode)
    speed: float = 1.0  # relative compute speed
    steps_done: int = 0
    comm_bytes_sent: int = 0
    send_time_s: float = 0.0
    recv_time_s: float = 0.0
    compute_time_s: float = 0.0
    drops: int = 0  # churn events survived (async mode)
    downtime_s: float = 0.0  # simulated time lost to churn
    reports: List[ExecutionReport] = field(default_factory=list)
    ef: Optional[Params] = None  # EF-SGD residual (lazily zero-init on first publish)


class LocalP2PCluster:
    """P peers, real compute, mailbox exchange, sync or async, on ``device``."""

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
        executor: Optional[ServerlessExecutor] = None,
        exchange: Optional[str] = None,  # registered protocol name
        graph: Any = "full",  # peer overlay: registered name or PeerGraph
        graph_seed: Optional[int] = None,  # defaults to `seed`
        qsgd: Optional[C.QSGDConfig] = None,
        topk_frac: float = 0.01,
        ef: bool = False,  # EF-SGD residual feedback for lossy codecs
        network_bandwidth_bps: float = 1e9,  # simulated inter-peer link
        peer_speeds: Optional[Sequence[float]] = None,
        churn_prob: float = 0.0,  # async: P(peer drops mid-step), per attempt
        churn_downtime_s: float = 1.0,  # async: rejoin delay after a drop
        adversary: Optional[AdversarySpec] = None,  # Byzantine attacker model
        reject_nonfinite: bool = False,  # drop NaN/Inf contributions at consume
        trim_frac: float = 0.0,  # trimmed_mean default (spec param overrides)
        krum_m: int = 1,  # multi-Krum default (spec param overrides)
        krum_f: Optional[int] = None,  # Krum's assumed Byzantine count
        robust_clip: float = 0.0,  # per-contribution norm clip, 0 = off
        sim_compute_s: Optional[Any] = None,  # float | callable(rank, epoch)
        tracer: Any = None,  # repro_torch.analysis.trace.TraceRecorder, optional
        init_params: Optional[Mapping[str, torch.Tensor]] = None,  # e.g. convert.from_jax(...)
        seed: int = 0,
        device: Any = "cuda",
    ):
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
        self.sync = sync
        self.executor = executor
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
        if self.protocol.sharded and not sync:
            raise ValueError(
                f"exchange protocol {self.protocol.name!r} is a barriered "
                "sharded exchange (scatter -> aggregate -> re-broadcast) and "
                "only runs in sync mode; use exchange='async' for "
                "asynchronous epochs"
            )
        # Adversary model: a seeded subset of peers publishes poisoned (or
        # stale-replayed) payloads through the same publish path honest
        # peers use.
        self.adversary = adversary
        self._attackers = (
            frozenset(adversary.attackers(num_peers)) if adversary is not None else frozenset()
        )
        if self._attackers and self.protocol.sharded:
            raise ValueError(
                f"exchange protocol {self.protocol.name!r} exchanges "
                "shard pieces, not whole-gradient payloads; the adversary "
                "model poisons whole-gradient publishes — use a dense "
                "protocol (allgather_mean / trimmed_mean / median / krum)"
            )
        # stale_replay: each attacker's last (payload, nbytes), a copy
        self._replay_cache: List[Optional[Tuple[Any, int]]] = [None] * num_peers
        self.reject_nonfinite = reject_nonfinite
        self.ef = bool(ef)
        if self.ef and self.protocol.sharded:
            raise ValueError(
                f"exchange protocol {self.protocol.name!r} exchanges shard "
                "pieces and bypasses the per-peer publish path; error "
                "feedback applies to lossy whole-gradient codecs (qsgd/topk)"
            )
        self.xctx = ExchangeContext(
            num_peers=num_peers, qsgd=qsgd, topk_frac=topk_frac, graph=self.graph,
            mixing=self._mixing, trim_frac=trim_frac, krum_m=krum_m, krum_f=krum_f,
            robust_clip=robust_clip,
        )
        self.link = LinkModel(bandwidth_bps=network_bandwidth_bps)
        # Deterministic virtual compute time: the async clock advances by
        # the measured compute time x speed, which varies run to run;
        # sim_compute_s (a constant, or callable(rank, epoch) -> seconds)
        # replaces the measurement so same-seed traces are identical.
        self.sim_compute_s = sim_compute_s
        self.tracer = tracer
        self.mailbox = HostMailbox(num_peers, graph=self.graph, tracer=tracer)
        self.detector = ConvergenceDetector(lr, mode="max", max_epochs=10_000)
        self.churn_prob = churn_prob
        self.churn_downtime_s = churn_downtime_s
        # one numpy stream for every async-epoch draw (churn), shared by the
        # engine each epoch builds: a fixed seed fixes the whole trajectory
        self._rng = np.random.default_rng(seed)
        self.last_event_order: List[int] = []  # rank processing order, last async epoch
        # One generator on the device for all of the cluster's randomness:
        # the model's init (replaced by init_params when given), then the
        # QSGD uniforms.
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # The attackers' scaled_noise draws: a stream of its own, seeded from
        # the adversary, as the reference keys them apart from the codec's.
        self.poison_generator = torch.Generator(device=self.device)
        self.poison_generator.manual_seed(adversary.seed if adversary is not None else 0)

        part = Partitioner(dataset, num_peers, shuffle_seed=seed)
        self.model = models.init_model(cfg, generator=self.generator, device=self.device)
        self.model.requires_grad_(False)  # a template: peers own the parameters
        if init_params is None:
            init_params = dict(self.model.named_parameters())
        # every parameter dict of the cluster holds its leaves in JAX order
        self.names = jax_order(init_params)
        init_params = {k: init_params[k].to(self.device, torch.float32) for k in self.names}
        self.peers: List[PeerState] = []
        speeds = list(peer_speeds or [1.0] * num_peers)
        for r in range(num_peers):
            params = {k: init_params[k].clone() for k in self.names}
            self.peers.append(
                PeerState(
                    rank=r,
                    params=params,
                    opt_state=optimizer.init(params),
                    loader=DataLoader(part, r, batch_size),
                    metrics=StageMetrics(),
                    speed=speeds[r],
                )
            )
        self._model_bytes = sum(init_params[k].numel() * 4 for k in self.names)
        # Sharded exchange: one contiguous shard per peer (gradients share
        # the params' structure), plus the per-epoch parallel-aggregation
        # reports when a serverless executor prices the aggregators.
        self.shard_plan = (
            self.protocol.plan(init_params, self.xctx) if self.protocol.sharded else None
        )
        self.aggregation_reports: List[ExecutionReport] = []

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

    def _batch_thunks(self, peer: PeerState, epoch: int):
        """One gradient thunk per batch of the peer's epoch, and the mean
        bytes of a host batch (the executor sizes Lambda memory from it)."""
        host = [
            peer.loader.load(BatchKey(peer.rank, epoch, i % peer.loader.num_batches))
            for i in range(self.batches_per_epoch)
        ]
        batch_bytes = sum(
            sum(b[k].nbytes for k in sorted(b)) for b in host
        ) // max(len(host), 1)
        batches = [self._to_device(b) for b in host]

        def mk(b):
            return lambda: self._grad(peer.params, b)

        return [mk(b) for b in batches], batch_bytes

    def _combine(self, outs):
        """AverageBatchesGradients: the f32 mean of the batches' gradients
        (summed in batch order), and the mean loss and accuracy."""
        gs = [o[0] for o in outs]
        with torch.no_grad():
            g = {k: sum(x[k].to(torch.float32) for x in gs) / len(gs) for k in self.names}
        loss = float(np.mean([float(o[1]) for o in outs]))
        acc = float(np.mean([float(o[2]) for o in outs]))
        return g, loss, acc

    def _compute_peer_gradient(self, peer: PeerState, epoch: int):
        """ComputeBatchGradients + AverageBatchesGradients (Algorithm 1).

        With an executor, it runs the thunks (the same gradients, in the
        same order), times each batch with the device synchronised, and
        prices the epoch: the report's wall time is the peer's compute
        time, its simulated stages go into the peer's metrics."""
        thunks, batch_bytes = self._batch_thunks(peer, epoch)
        if self.executor is not None:
            (g, loss, acc), report = self.executor.run(
                thunks,
                model_bytes=self._model_bytes,
                batch_bytes=batch_bytes,
                combine=self._combine,
                epoch=epoch,
                peer=peer.rank,
            )
            peer.reports.append(report)
            if report.backend == "serverless":
                # engine-simulated per-invocation stages, Table-I style
                peer.metrics.add_simulated("cold_start", report.cold_start_s)
                peer.metrics.add_simulated("queue_wait", report.queue_wait_s)
                peer.metrics.add_simulated("retry", report.retry_s)
            else:
                # instance baseline: VM provisioning + churn gaps (the
                # cluster's own link charges exchange wire separately)
                peer.metrics.add_simulated("boot", report.boot_s)
                peer.metrics.add_simulated("churn_downtime", report.downtime_s)
            compute_wall = report.wall_time_s
        else:
            t0 = time.perf_counter()
            g, loss, acc = self._combine([t() for t in thunks])
            compute_wall = time.perf_counter() - t0
        if self.sim_compute_s is not None:
            compute_wall = float(
                self.sim_compute_s(peer.rank, epoch)
                if callable(self.sim_compute_s) else self.sim_compute_s
            )
        peer.compute_time_s += compute_wall
        return g, loss, acc, compute_wall

    def _publish(self, peer: PeerState, grads: Params, epoch: int, at_time: float):
        """SendGradientsToMyQueue via the exchange protocol's wire format.

        Byzantine peers poison here. ``sign_flip`` / ``scaled_noise``
        transform the gradient before encoding (composes with any codec);
        ``stale_replay`` re-publishes the attacker's previous epoch's encoded
        payload, cached as a copy. As in the reference's code (not its
        docstring), the attacker's own contribution is the poisoned gradient
        too, and under EF the poison enters its residual (ROADMAP.md, Queue
        3, reference behaviour 15).

        Returns this peer's OWN contribution for the consume/update phase:
        the (poisoned) gradient normally, or — under error feedback — the
        decoded image of the encoded payload, with the residual (what the
        codec dropped) accumulated into ``peer.ef`` for re-injection next
        step.
        """
        poisoned = False
        attacker = peer.rank in self._attackers
        if attacker and self.adversary.attack != "stale_replay":
            grads = poison_gradients(grads, self.adversary, self.poison_generator)
            poisoned = True
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
            if attacker and self.adversary.attack == "stale_replay":
                replayed = self._replay_cache[peer.rank]
                self._replay_cache[peer.rank] = (_copy_payload(payload), nbytes)
                if replayed is not None:
                    payload, nbytes = replayed  # epoch e ships epoch e-1's wire
                    poisoned = True
            msg = (self.protocol.name, payload)
            self._sync()
            wire_s = self.link.transfer_s(nbytes)
            self.mailbox.publish(
                peer.rank, msg, nbytes=nbytes, time=at_time + wire_s, epoch=epoch,
                poisoned=poisoned,
            )
        peer.comm_bytes_sent += nbytes
        peer.send_time_s += wire_s
        return own

    def _consume_all(self, peer: PeerState, own_grads: Params, at_time: Optional[float]):
        """ConsumeGradientsFromQueue along the peer's overlay edges.

        Returns ``(contribs, recv_wire_s)``: ``[(rank, gradient), ...]``,
        the peer's own contribution first, then each neighbour's decoded
        gradient in ascending rank, the order in which the reference sums
        them; and the receive-side wire time (payload download plus the S3
        round trip of indirected messages), which async epochs add to the
        peer's clock. ``at_time`` (async) hides what is published later.
        With ``reject_nonfinite`` a contribution holding NaN or Inf is
        dropped after its download is charged."""
        contribs = [(peer.rank, own_grads)]
        recv_wire_s = 0.0
        with peer.metrics.stage("receive_gradients"):
            for other in self.graph.neighbors(peer.rank):
                msg = self.mailbox.consume(other, at_time=at_time, consumer=peer.rank)
                if msg is None:
                    continue  # async: nothing published yet -> skip
                _, payload = msg.payload
                decoded = self.protocol.host_decode(payload, own_grads, self.xctx)
                wire_s = self.mailbox.download_time_s(msg, link=self.link)
                peer.recv_time_s += wire_s
                recv_wire_s += wire_s
                if self.reject_nonfinite and not tree_all_finite(decoded):
                    # the bytes crossed the wire (charged above); the
                    # contribution is dropped at the trust boundary
                    self.mailbox.stats["rejected_nonfinite"] += 1
                    continue
                contribs.append((other, decoded))
        return contribs, recv_wire_s

    def _update(self, peer: PeerState, contribs, lr: float):
        """Mix the consumed gradients and step the peer's optimizer.

        Robust protocols (trimmed mean / median / Krum) take over the whole
        combine via :meth:`ExchangeProtocol.host_combine`; otherwise, on the
        full graph, the plain mean over contributions, and on a sparse
        graph Metropolis–Hastings weights ``W[r]``, renormalized over the
        contributions that arrived.
        """
        with peer.metrics.stage("model_update"), torch.no_grad():
            robust = self.protocol.host_combine(contribs, peer.rank, self.xctx)
            if robust is not None:
                avg = robust
            elif self._mixing is None:
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

    def _shard_publish(self, peer: PeerState, values: torch.Tensor, epoch: int, shard) -> None:
        """Publish one shard-addressed buffer through the shard wire codec."""
        payload, nbytes = self.protocol.host_encode_shard(values, self.xctx)
        wire_s = self.link.transfer_s(nbytes)
        self.mailbox.publish(peer.rank, payload, nbytes=nbytes, time=wire_s, epoch=epoch,
                             shard=shard)
        peer.comm_bytes_sent += nbytes
        peer.send_time_s += wire_s

    def _shard_consume(self, peer: PeerState, other: int, shard) -> torch.Tensor:
        """Consume one shard-addressed buffer, charge its download, decode it."""
        msg = self.mailbox.consume(other, consumer=peer.rank, shard=shard)
        peer.recv_time_s += self.mailbox.download_time_s(msg, link=self.link)
        return self.protocol.host_decode_shard(msg.payload, self.xctx)

    def _price_aggregation(self, per_agg_s: List[float], shard_bytes: int,
                           num_contributions: int, epoch: int) -> None:
        """One parallel wave of aggregator invocations on the serverless
        executor, when one is attached."""
        if self.executor is not None and self.executor.backend == "serverless":
            self.aggregation_reports.append(self.executor.simulate_aggregation(
                per_agg_s, shard_bytes=shard_bytes, num_contributions=num_contributions,
                epoch=epoch, link=self.link,
            ))

    def _sharded_exchange_sync(self, grads: Dict[int, Params], epoch: int):
        """Shard-addressed exchange (the ``reduce_scatter`` host image).

        Three phases over the mailbox, shards — not whole gradients — on the
        wire:

        1. **scatter** — each peer splits its gradient into P contiguous
           shards (:class:`~repro_torch.core.shard.ShardPlan`) and publishes
           one piece per foreign shard owner (``shard=("piece", j)``).
        2. **aggregate** — owner ``j`` consumes only the pieces of its
           shard, sums them after its own piece (``model / P`` elements per
           contribution), divides by P and re-broadcasts the mean shard
           (``shard=("agg",)``). Each reduce is timed with the card
           synchronised before and after; with a serverless executor the P
           concurrent aggregators are priced with memory sized from shard
           bytes.
        3. **gather** — every peer consumes the P-1 foreign mean shards,
           reassembles the buffer in shard order, unflattens it to the
           global mean, and steps its optimizer.
        """
        plan, P = self.shard_plan, self.num_peers
        rows: List[Optional[torch.Tensor]] = [None] * P
        for peer in self.peers:
            r = peer.rank
            with peer.metrics.stage("send_gradients"), torch.no_grad():
                rows[r] = plan.shards(grads[r])  # (P, S)
                self._sync()
                for j in range(P):
                    if j != r:  # own piece never leaves the peer
                        self._shard_publish(peer, rows[r][j], epoch, ("piece", j))
        agg_rows: List[Optional[torch.Tensor]] = [None] * P
        per_shard_s: List[float] = []
        for peer in self.peers:
            r = peer.rank
            with peer.metrics.stage("receive_gradients"):
                pieces = [rows[r][r].to(torch.float32)]
                pieces.extend(self._shard_consume(peer, other, ("piece", r))
                              for other in range(P) if other != r)
            self._sync()
            t0 = time.perf_counter()
            agg = sum(pieces[1:], pieces[0]) / P
            self._sync()
            per_shard_s.append(time.perf_counter() - t0)
            agg_rows[r] = agg
            with peer.metrics.stage("send_gradients"):
                self._shard_publish(peer, agg, epoch, ("agg",))
        self._price_aggregation(per_shard_s, plan.shard_bytes(self.xctx.wire_dtype), P, epoch)
        for peer in self.peers:
            r = peer.rank
            with peer.metrics.stage("receive_gradients"):
                bank = [agg_rows[r] if j == r else self._shard_consume(peer, j, ("agg",))
                        for j in range(P)]
            with peer.metrics.stage("model_update"):
                self._apply_avg(peer, plan.unflatten(torch.stack(bank)), self.detector.lr)

    def _tree_exchange_sync(self, grads: Dict[int, Params], epoch: int):
        """Hierarchical tree exchange (the ``tree[:fanout]`` host image).

        Peers form the protocol's k-ary :class:`~repro_torch.core.tree.TreePlan`
        and run two sweeps over the mailbox, whole flattened buffers on the
        wire:

        1. **up-sweep** — deepest level first: every non-root peer publishes
           its partial sum (own buffer + its children's partials, in child
           order) to its ``shard=("up",)`` register. The root divides the
           global sum by ``P``.
        2. **down-sweep** — root to leaves: each hub publishes the mean once
           to its ``shard=("down",)`` register and its children read it.

        Each hub's fan-in is timed with the card synchronised before and
        after; with a serverless executor each level's hubs are priced as
        one parallel wave with memory sized from buffer bytes.
        """
        plan, P = self.shard_plan, self.num_peers
        tp = self.protocol.tree_plan(P)
        itemsize = torch.empty((), dtype=self.xctx.wire_dtype).element_size()
        partial: List[Optional[torch.Tensor]] = [None] * P
        for level in range(tp.depth - 1, -1, -1):
            start, stop = tp.level_bounds(level)
            per_hub_s: List[float] = []
            for r in range(start, stop):
                peer = self.peers[r]
                kids = tp.children(r)
                self._sync()
                t0 = time.perf_counter()
                with torch.no_grad():
                    acc = plan.flatten(grads[r]).to(torch.float32)
                with peer.metrics.stage("receive_gradients"):
                    for c in kids:
                        acc = acc + self._shard_consume(peer, c, ("up",))
                self._sync()
                if kids:
                    per_hub_s.append(time.perf_counter() - t0)
                partial[r] = acc
                if r != 0:
                    with peer.metrics.stage("send_gradients"):
                        self._shard_publish(peer, acc, epoch, ("up",))
            if per_hub_s:  # one parallel aggregation wave per hub level
                self._price_aggregation(per_hub_s, plan.padded_size * itemsize,
                                        tp.fanout + 1, epoch)
        down: List[Optional[torch.Tensor]] = [None] * P
        down[0] = partial[0] / P
        for level in range(tp.depth):
            start, stop = tp.level_bounds(level)
            for r in range(start, stop):
                peer = self.peers[r]
                if r != 0:
                    with peer.metrics.stage("receive_gradients"):
                        down[r] = self._shard_consume(peer, tp.parent(r), ("down",))
                if tp.children(r):
                    with peer.metrics.stage("send_gradients"):
                        self._shard_publish(peer, down[r], epoch, ("down",))
        for peer in self.peers:
            with peer.metrics.stage("model_update"):
                self._apply_avg(peer, plan.unflatten(down[peer.rank]), self.detector.lr)

    def comm_cost(self, *, usd_per_gb: float = 0.0) -> CommCost:
        """Per-step wire cost of one peer under protocol + overlay graph:
        one publish's payload per edge times the peer's mean degree, O(P)
        on the full mesh and O(degree) on sparse overlays. (The simulated
        link also charges one publish per step, ``_publish``, on top of the
        degree-many downloads counted here.) A sharded protocol's per-edge
        payload is one shard and its per-step total the protocol's own
        accounting, ``2 (P - 1)`` shards (the peer's downloads)."""
        if self.protocol.sharded:
            like = self.peers[0].params
            return CommCost(
                wire_bytes_per_step=self.protocol.wire_bytes(like, self.xctx),
                bandwidth_bps=self.link.bandwidth_bps,
                usd_per_gb_egress=usd_per_gb,
                bytes_per_edge=self.protocol.wire_bytes_per_edge(like, self.xctx),
                degree=self.xctx.degree,
                graph_name=self.graph.name,
                num_shards=self.shard_plan.num_shards,
                shard_bytes=self.shard_plan.shard_bytes(self.xctx.wire_dtype),
            )
        per_edge = self.protocol.host_wire_bytes(self.peers[0].params, self.xctx)
        return CommCost(
            wire_bytes_per_step=int(round(per_edge * self.xctx.degree)),
            bandwidth_bps=self.link.bandwidth_bps,
            usd_per_gb_egress=usd_per_gb,
            bytes_per_edge=per_edge,
            degree=self.xctx.degree,
            graph_name=self.graph.name,
        )

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
        sharded = self.protocol.sharded
        for peer in self.peers:
            with peer.metrics.stage("compute_gradients"):
                g, loss, acc, _ = self._compute_peer_gradient(peer, epoch)
            stats.append((loss, acc))
            # own contribution for the update phase: the decoded image of
            # the published payload under EF, the raw gradient else; the
            # sharded protocols publish in their own exchange below
            grads[peer.rank] = g if sharded else self._publish(peer, g, epoch, at_time=0.0)
            self.mailbox.barrier_signal(peer.rank, epoch)
        if not self.mailbox.barrier_complete(epoch):  # SynchronisationBarrier
            raise RuntimeError(
                f"synchronisation barrier incomplete for epoch {epoch}: not "
                f"every peer signalled completion before the consume phase"
            )
        self.mailbox.barrier_reset(epoch)
        if sharded and self.protocol.hierarchical:
            self._tree_exchange_sync(grads, epoch)
        elif sharded:
            self._sharded_exchange_sync(grads, epoch)
        else:
            for peer in self.peers:
                contribs, _ = self._consume_all(peer, grads[peer.rank], at_time=None)
                self._update(peer, contribs, self.detector.lr)
        loss = float(np.mean([s[0] for s in stats]))
        acc = float(np.mean([s[1] for s in stats]))
        return {"loss": loss, "acc": acc}

    def run_epoch_async(self, epoch: int) -> Dict[str, float]:
        """Async epoch on the event engine: no barrier, stale gradients allowed.

        Events fire in ``(virtual time, rank)`` order. With ``churn_prob >
        0`` a peer may drop mid-step (SPIRT-style): the partial work is
        lost, the peer rejoins ``churn_downtime_s`` later and redoes the
        step (at most 5 drops a step), while other peers keep consuming its
        last published (stale) gradient.
        """
        engine = EventEngine(rng=self._rng, tracer=self.tracer)
        engine.now = min((p.clock for p in self.peers), default=0.0)
        stats = []
        order = self.last_event_order = []

        def schedule_peer(peer: PeerState):
            cache: Dict[str, Any] = {}

            def compute_fire():
                order.append(peer.rank)
                with peer.metrics.stage("compute_gradients"):
                    g, loss, acc, wall = self._compute_peer_gradient(peer, epoch)
                cache.update(g=g, loss=loss, acc=acc, wall=wall, attempts=0)
                attempt_fire()

            def attempt_fire():
                sim_wall = cache["wall"] * peer.speed
                cache["attempts"] += 1
                if (
                    self.churn_prob > 0.0
                    and cache["attempts"] <= 5  # then forcibly stay up
                    and engine.rng.random() < self.churn_prob
                ):
                    # dropped mid-compute: partial work lost, rejoin later
                    lost = sim_wall * engine.rng.random() + self.churn_downtime_s
                    peer.clock += lost
                    peer.drops += 1
                    peer.downtime_s += lost
                    engine.schedule_at(peer.clock, attempt_fire, priority=peer.rank)
                    return
                peer.clock += sim_wall
                own = self._publish(peer, cache["g"], epoch, at_time=peer.clock)
                contribs, recv_wire_s = self._consume_all(peer, own, at_time=peer.clock)
                peer.clock += recv_wire_s
                self._update(peer, contribs, self.detector.lr)
                stats.append((cache["loss"], cache["acc"]))

            engine.schedule_at(peer.clock, compute_fire, priority=peer.rank)

        for peer in self.peers:
            schedule_peer(peer)
        engine.run()
        loss = float(np.mean([s[0] for s in stats]))
        acc = float(np.mean([s[1] for s in stats]))
        return {"loss": loss, "acc": acc}

    def run(self, epochs: int, *, eval_every: int = 1) -> List[Dict[str, float]]:
        history = []
        for e in range(epochs):
            rec = self.run_epoch_sync(e) if self.sync else self.run_epoch_async(e)
            if (e + 1) % eval_every == 0:
                vloss, vacc = self.evaluate(epoch=10_000 + e)
                rec.update(val_loss=vloss, val_acc=vacc)
                if self.detector.step(vacc):
                    history.append({**rec, "epoch": e, "converged": True})
                    break
            history.append({**rec, "epoch": e})
        return history
