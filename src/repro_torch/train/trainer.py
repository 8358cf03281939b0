"""P2PTrainer — the one-object facade over the port's P2P training stack,
the twin of the reference's ``repro/train/trainer.py``.

Bundles topology resolution, exchange-protocol lookup, step building,
state init, checkpointing, wire cost and the serverless and instance
accounting behind one API::

    trainer = P2PTrainer(cfg, optimizer, topo, num_peers, schedule)
    state = trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
    state, metrics = trainer.step(state, batch)
    print(trainer.comm_cost().seconds_per_step)

Where the reference takes a mesh, the port takes ``num_peers``: the peers
are a stacked leading dimension on one card (``core/p2p.py``). One peer is
the reference's single worker (a mesh without peer axes): the step
exchanges nothing and the state has no mailbox or EF bank. The default
step is ``train.build_train_step``'s LM step over ``lm_loss`` (it donates
its state and switches the card's allocator to expandable segments);
with ``loss_fn`` the step is ``build_p2p_train_step`` over it. Used by
``launch/train.py`` and ``examples/p2p_serverless_train.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Union

import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost import CommCost, compare_backends
from repro_torch.core.events import AllocationPolicy, InstanceConfig, LinkModel, RuntimeConfig
from repro_torch.core.exchange import ExchangeProtocol
from repro_torch.core.p2p import (
    Topology,
    TrainState,
    as_train_state,
    build_p2p_train_step,
    exchange_context,
    init_ef,
    peer_bank,
)
from repro_torch.core.robust import AdversarySpec
from repro_torch.core.scheduler import (
    FleetExecutor,
    FleetPlan,
    FleetReport,
    Scheduler,
    evaluate_candidates,
    get_scheduler,
    standard_candidates,
)
from repro_torch.core.serverless import ExecutionReport, ServerlessExecutor
from repro_torch.core.shard import ShardPlan
from repro_torch.core.simulate import resolve_device
from repro_torch.optim import Optimizer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.steps import build_train_step, init_train_state


class P2PTrainer:
    """Facade over loss/step/exchange/state for P2P training on one card."""

    def __init__(
        self,
        cfg: ModelConfig,
        optimizer: Optimizer,
        topo: Topology,
        num_peers: int,
        schedule: Callable,
        *,
        loss_fn: Optional[Callable] = None,  # (params, batch) -> (loss, aux)
        moe_dispatch: str = "dense",
        use_ssd_kernel: bool = False,
        runtime: Optional[RuntimeConfig] = None,  # serverless fault/cold-start model
        allocation: Union[str, AllocationPolicy] = "static",  # per-epoch memory sizing
        graph: Any = None,  # overlay override: name ("ring", "gossip:3") or PeerGraph
        backend: str = "serverless",  # which accounting model `account()` prices
        instance_type: str = "t2.large",  # EC2 tier of the instance baseline
        instance_config: Optional[InstanceConfig] = None,  # boot/churn model
        adversary: Optional[AdversarySpec] = None,  # Byzantine peers among the P
        ef: Optional[bool] = None,  # error feedback override (else topo.ef)
        scheduler: Union[str, Scheduler, None] = None,  # cost-aware plan picker
        device: Any = "cuda",
    ):
        if backend not in ("serverless", "instance"):
            raise ValueError(
                f"backend must be 'serverless' or 'instance', got {backend!r}"
            )
        if graph is not None:
            topo = dataclasses.replace(topo, graph=graph)
        if ef is not None:
            topo = dataclasses.replace(topo, ef=bool(ef))
        self.cfg = cfg
        self.optimizer = optimizer
        self.topo = topo
        self.schedule = schedule
        self.device = resolve_device(device)
        self.backend = backend
        self.instance_type = instance_type
        self.instance_config = instance_config or InstanceConfig()
        # raw arg, so FleetExecutor's per-tier defaults (GPU boot preset)
        # apply unless the caller explicitly pinned a config
        self._fleet_instance_config = instance_config
        self.runtime_config = runtime or RuntimeConfig()
        self.allocation = allocation
        if isinstance(scheduler, str):
            scheduler = get_scheduler(scheduler)
        self.scheduler: Optional[Scheduler] = scheduler
        self._serverless: Optional[ServerlessExecutor] = None
        self._instance_executor: Optional[ServerlessExecutor] = None
        self._fleet: Optional[FleetExecutor] = None
        self.protocol: ExchangeProtocol = topo.protocol()
        self.ctx = exchange_context(topo, num_peers=num_peers)
        self.adversary = adversary
        # one peer: the reference's single worker, no exchange (the plain
        # mean over one peer is its gradient) and no adversary
        step_topo = topo if num_peers > 1 else dataclasses.replace(
            topo, exchange="allgather_mean", graph="full", ef=False, exchange_dtype="float32")
        step_adversary = adversary if num_peers > 1 else None
        self.banked = num_peers > 1 and (self.protocol.is_async or self.ctx.mixing is not None)
        self.loss_fn = loss_fn
        if loss_fn is None:
            self._step = build_train_step(cfg, optimizer, step_topo, num_peers, schedule,
                                          moe_dispatch=moe_dispatch, use_ssd_kernel=use_ssd_kernel,
                                          adversary=step_adversary, device=self.device)
        else:
            self._step = build_p2p_train_step(loss_fn, optimizer, step_topo, num_peers, schedule,
                                              adversary=step_adversary, device=self.device)

    @property
    def num_peers(self) -> int:
        return self.ctx.num_peers

    @property
    def graph(self):
        """The resolved :class:`~repro_torch.core.graph.PeerGraph` overlay."""
        return self.ctx.graph

    def shard_plan(self, params_like=None) -> Optional[ShardPlan]:
        """The sharded-exchange layout (one shard per peer), or ``None``
        when the active protocol exchanges whole leaves."""
        if not self.protocol.sharded:
            return None
        if params_like is None:
            params_like = self._params_like()
        return self.protocol.plan(params_like, self.ctx)

    def _params_like(self):
        """The params' shapes and dtypes, on the ``meta`` device."""
        if not hasattr(self, "_meta_params"):
            model = models.init_model(self.cfg, generator=None, device="meta")
            self._meta_params = dict(model.named_parameters())
        return self._meta_params

    # -- state ---------------------------------------------------------------
    def init_state(self, generator) -> TrainState:
        """A fresh state from ``generator`` on the trainer's device; with
        peers, the protocol's mailbox and (``topo.ef``) a zero EF bank, and
        on a sparse overlay or under ``async`` a ``PeerBank`` of params and
        moments."""
        state = init_train_state(generator, self.cfg, self.optimizer, device=self.device)
        if self.num_peers > 1:
            mailbox = self.protocol.init_state(state.params, self.ctx)
            if mailbox is not None:
                state = state.replace(mailbox=mailbox)
            if self.topo.ef:
                # EF residual bank (zeros), kept for lossless protocols too:
                # their residual stays identically zero
                state = state.replace(ef=init_ef(state.params, self.num_peers))
            if self.banked:
                params, opt_state = peer_bank(state.params, state.opt_state, self.num_peers)
                state = state.replace(params=params, opt_state=opt_state)
        return state

    # -- stepping ------------------------------------------------------------
    def step(self, state, batch):
        """One P2P train step; returns (new_state, metrics)."""
        return self._step(as_train_state(state), batch)

    # -- accounting ----------------------------------------------------------
    def wire_bytes_per_step(self, params_like=None) -> int:
        """Bytes one peer publishes per step under the active protocol."""
        if params_like is None:
            params_like = self._params_like()
        return self.protocol.wire_bytes(params_like, self.ctx)

    def comm_cost(
        self, params_like=None, *, bandwidth_bps: float = 1e9,
        usd_per_gb: float = 0.0,
    ) -> CommCost:
        """Per-step exchange cost, straight from the protocol's byte counts
        (degree-aware: per-edge payload x the overlay graph's degree)."""
        if params_like is None:
            params_like = self._params_like()
        plan = self.shard_plan(params_like)
        return CommCost(
            wire_bytes_per_step=self.protocol.wire_bytes(params_like, self.ctx),
            bandwidth_bps=bandwidth_bps,
            usd_per_gb_egress=usd_per_gb,
            bytes_per_edge=(
                self.protocol.wire_bytes_per_edge(params_like, self.ctx)
                if self.protocol.decomposes_per_edge else 0
            ),
            degree=self.ctx.degree,
            graph_name=self.ctx.graph.name if self.ctx.graph is not None else "full",
            num_shards=plan.num_shards if plan is not None else 1,
            shard_bytes=(
                plan.shard_bytes(self.ctx.wire_dtype) if plan is not None else 0
            ),
        )

    @property
    def serverless(self) -> ServerlessExecutor:
        """The trainer's serverless accountant, built from ``runtime`` /
        ``allocation``. Warm pools and allocation history persist across
        :meth:`account_serverless` calls, like a long-lived deployment."""
        if self._serverless is None:
            self._serverless = ServerlessExecutor(
                backend="serverless",
                runtime=self.runtime_config,
                allocation=self.allocation,
            )
        return self._serverless

    def account_serverless(
        self,
        per_batch_s: Sequence[float],
        *,
        batch_bytes: int = 0,
        epoch: Optional[int] = None,
        peer: Any = 0,
        egress_bytes: int = 0,  # e.g. steps x comm_cost().wire_bytes_per_step
        usd_per_gb_egress: float = 0.0,
    ) -> ExecutionReport:
        """Price measured per-batch times under the serverless runtime: what
        these batch times would have taken and cost on Lambda under the
        configured fault/cold-start model and allocation policy (simulated
        accounting, not a measurement of Lambda). Model bytes come from the
        config's parameter shapes (fp32), no allocation happens."""
        return self.serverless.simulate(
            per_batch_s,
            model_bytes=self.model_bytes,
            batch_bytes=batch_bytes,
            epoch=epoch,
            peer=peer,
            egress_bytes=egress_bytes,
            usd_per_gb_egress=usd_per_gb_egress,
        )

    @property
    def model_bytes(self) -> int:
        """fp32 parameter bytes from the config's shapes on the ``meta``
        device (no allocation) — sizes both Lambda memory and the instance
        baseline's memory-constrained splitting."""
        return sum(p.numel() * 4 for p in self._params_like().values())

    @property
    def instance_executor(self) -> ServerlessExecutor:
        """The instance-baseline accountant: same executor type, backend
        "instance", pricing on the discrete-event ``InstanceRuntime``
        (boot, per-second billing incl. idle, churn). VM state and epoch
        history persist across :meth:`account_instance` calls."""
        if self._instance_executor is None:
            self._instance_executor = ServerlessExecutor(
                backend="instance",
                instance=self.instance_type,
                instance_config=self.instance_config,
            )
        return self._instance_executor

    def account_instance(
        self,
        per_batch_s: Sequence[float],
        *,
        batch_bytes: int = 0,
        epoch: Optional[int] = None,
        peer: Any = 0,
        charge_exchange: bool = False,  # add degree-aware wire time
        bandwidth_bps: float = 1e9,
        barrier_wait_s: float = 0.0,  # billed idle at the sync barrier
        reference_vcpus: Optional[float] = None,
        strict_fit: bool = False,  # True: refuse a model that overflows the tier
    ) -> ExecutionReport:
        """Price measured per-batch times under the instance baseline: the
        same batch times run one after another on the trainer's
        ``instance_type`` VM (boot delay, per-second billing including idle,
        memory-constrained mini-batch splitting and, with
        ``charge_exchange=True``, one upload plus degree-many downloads
        through the overlay graph's ``LinkModel``)."""
        upload_bytes, download_bytes, link = 0, (), None
        if charge_exchange:
            cc = self.comm_cost(bandwidth_bps=bandwidth_bps)
            link = LinkModel(bandwidth_bps=bandwidth_bps)
            if cc.bytes_per_edge:
                upload_bytes = cc.bytes_per_edge
                download_bytes = [cc.bytes_per_edge] * int(round(cc.degree))
            else:  # fused collective: one aggregate transfer figure
                download_bytes = [cc.wire_bytes_per_step]
        return self.instance_executor.simulate_instance(
            per_batch_s,
            model_bytes=self.model_bytes,
            batch_bytes=batch_bytes,
            epoch=epoch,
            peer=peer,
            reference_vcpus=reference_vcpus,
            upload_bytes=upload_bytes,
            download_bytes=download_bytes,
            link=link,
            barrier_wait_s=barrier_wait_s,
            strict_fit=strict_fit,
        )

    def account(self, per_batch_s: Sequence[float], **kw) -> ExecutionReport:
        """Price per-batch times under the trainer's configured backend
        (``backend="serverless" | "instance"``); keyword arguments pass
        through to :meth:`account_serverless` / :meth:`account_instance`."""
        if self.backend == "instance":
            return self.account_instance(per_batch_s, **kw)
        return self.account_serverless(per_batch_s, **kw)

    def cost_frontier(
        self,
        per_batch_s: Sequence[float],
        *,
        batch_bytes: int = 0,
        epoch: int = 0,
        peer: Any = 0,
    ) -> dict:
        """Both backends priced on the same measured epoch: ``{"serverless":
        CostReport, "instance": CostReport, "speedup_pct", "cost_multiple",
        ...}``. The gradient-computation stage only (no exchange wire on
        either side), each side on fresh accountants built from the
        trainer's configs: a pure function of the measured times."""
        s_ex = ServerlessExecutor(
            runtime=self.runtime_config, allocation=self.allocation,
        )
        i_ex = ServerlessExecutor(
            backend="instance", instance=self.instance_type,
            instance_config=self.instance_config,
        )
        s = s_ex.simulate(
            per_batch_s, model_bytes=self.model_bytes,
            batch_bytes=batch_bytes, epoch=epoch, peer=peer,
        )
        i = i_ex.simulate_instance(
            per_batch_s, model_bytes=self.model_bytes,
            batch_bytes=batch_bytes, epoch=epoch, peer=peer,
            strict_fit=False,
        )
        sr = s.cost_report(num_peers=self.num_peers, label="serverless")
        ir = i.cost_report(num_peers=self.num_peers, label=self.instance_type)
        return {"serverless": sr, "instance": ir, **compare_backends(sr, ir)}

    @property
    def fleet_executor(self) -> FleetExecutor:
        """The trainer's heterogeneous-fleet accountant: Lambda peers on
        the configured serverless runtime, instance peers on one VM fleet
        per tier. Warm pools and VM state persist across
        :meth:`account_fleet` calls."""
        if self._fleet is None:
            self._fleet = FleetExecutor(
                runtime=self.runtime_config,
                instance_config=self._fleet_instance_config,
                allocation=(
                    self.allocation
                    if isinstance(self.allocation, str)
                    else "static"
                ),
            )
        return self._fleet

    def account_fleet(
        self,
        plan: FleetPlan,
        per_peer_batch_s: Sequence[Sequence[float]],
        *,
        batch_bytes: int = 0,
        epoch: Optional[int] = None,
    ) -> FleetReport:
        """Price one heterogeneous fleet epoch: ``per_peer_batch_s[rank]``
        runs on ``plan.assignments[rank]``'s backend."""
        return self.fleet_executor.run_epoch(
            plan,
            per_peer_batch_s,
            model_bytes=self.model_bytes,
            batch_bytes=batch_bytes,
            epoch=epoch,
        )

    def schedule_epoch(
        self,
        per_peer_batch_s: Sequence[Sequence[float]],
        *,
        batch_bytes: int = 0,
        candidates: Optional[Sequence[FleetPlan]] = None,
        deadline_s: Optional[float] = None,
        budget_usd: Optional[float] = None,
        warm: bool = True,
    ) -> dict:
        """Let the configured scheduler pick next epoch's plan from every
        candidate measured on fresh executors against this epoch's per-peer
        batch times. Returns ``{"plan", "report", "index", "candidates"}``."""
        if self.scheduler is None:
            raise ValueError(
                "no scheduler configured; construct "
                "P2PTrainer(scheduler='cheapest_under_deadline' | "
                "'fastest_under_budget' | 'pareto_walk')"
            )
        if candidates is None:
            candidates = standard_candidates(len(per_peer_batch_s))
        reports = evaluate_candidates(
            candidates,
            per_peer_batch_s,
            model_bytes=self.model_bytes,
            batch_bytes=batch_bytes,
            warm=warm,
            runtime=self.runtime_config,
            instance_config=self._fleet_instance_config,
        )
        idx = self.scheduler.choose(
            reports, deadline_s=deadline_s, budget_usd=budget_usd
        )
        return {
            "plan": candidates[idx],
            "report": reports[idx],
            "index": idx,
            "candidates": list(reports),
        }

    def account_aggregation(
        self,
        per_shard_s: Optional[Sequence[float]] = None,
        *,
        reduce_bytes_per_s: float = 4e9,
        epoch: Optional[int] = None,
        peer: Any = 0,
        link=None,
        usd_per_gb_egress: float = 0.0,
    ) -> ExecutionReport:
        """Price the sharded aggregation stage as P parallel Lambdas (a
        sharded protocol only). Without measured ``per_shard_s`` each
        aggregator's reduce time is estimated from shard bytes x
        contributions at ``reduce_bytes_per_s``; memory is sized from shard
        bytes."""
        plan = self.shard_plan()
        if plan is None:
            raise ValueError(
                f"exchange protocol {self.protocol.name!r} is not sharded; "
                "aggregation accounting applies to reduce_scatter-style "
                "protocols only"
            )
        P = self.num_peers
        if per_shard_s is None:
            t = plan.shard_bytes(self.ctx.wire_dtype) * P / reduce_bytes_per_s
            per_shard_s = [t] * plan.num_shards
        return self.serverless.simulate_aggregation(
            per_shard_s,
            shard_bytes=plan.shard_bytes(self.ctx.wire_dtype),
            num_contributions=P,
            epoch=epoch,
            peer=peer,
            link=link,
            usd_per_gb_egress=usd_per_gb_egress,
        )

    # -- checkpointing -------------------------------------------------------
    def save(self, path: str, state, *, extra: Optional[dict] = None) -> None:
        """A v2 checkpoint of ``state`` in the reference's layout."""
        ckpt.save_state(path, as_train_state(state), extra=extra, cfg=self.cfg)

    def restore(self, path: str, like: Optional[TrainState] = None) -> TrainState:
        """The state of a v2 checkpoint (or the params of a v1), the port's
        or the reference's, in ``like``'s structure (by default a fresh
        state)."""
        if like is None:
            like = self.init_state(torch.Generator(device=self.device).manual_seed(0))
        state, _ = ckpt.restore_state(path, like, cfg=self.cfg)
        return state

