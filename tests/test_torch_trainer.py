"""The port's ``P2PTrainer`` (``repro_torch.train.trainer``) against the
reference's ``repro/train/trainer.py``, on the CPU.

* Wire bytes, ``comm_cost``, ``model_bytes`` and ``shard_plan`` equal the
  reference's trainer's for the same config, protocol, overlay and peer
  count (the reference's built on a stand-in mesh of that shape: these
  methods read only its axis sizes): squeezenet1.1 under every kind of
  protocol, reduced qwen2.5-3b under the whole-leaf and sharded ones.
  The LM's ``qsgd`` and ``topk`` counts differ by design: the port
  exchanges per layer, the reference per stacked leaf of ``n_groups``
  layers, so the per-leaf bucket padding and k rounding differ; the port's
  count is its own leaves' (pinned below).
* The accounting (serverless, instance with the exchange charged, the
  configured backend, the cost frontier, a fleet, the scheduler's pick,
  the sharded aggregation) equals the reference's field for field on the
  same injected per-batch times.
* Two steps of reduced qwen2.5-3b with ``remat`` on both sides, 2 peers x
  batch 2, Adam at 3e-3, ``allgather_mean`` (the bank-free mean) and with
  ``grad_clip=1.0`` (the per-peer bank): the reference's trainer saves its
  state (``trainer.save``) and the port's trainer restores it
  (``trainer.restore``), then both step on the same batches; losses, params
  and moments at ``tests/test_torch_train_steps.py``'s tolerances, and the
  port's ``aux`` row 0 against the reference's printed one (behaviour 21).
"""
import dataclasses
import inspect
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.compression import QSGDConfig as JQ
from repro.core.p2p import Topology as JTopology
from repro.core.scheduler import FleetPlan as JFleetPlan
from repro.core.scheduler import PeerAssignment as JPeerAssignment
from repro.optim import adam as jadam
from repro.train import P2PTrainer as JP2PTrainer
from repro_torch.configs import get_config, reduced
from repro_torch.core.compression import QSGDConfig
from repro_torch.core.p2p import Topology
from repro_torch.core.scheduler import FleetPlan, PeerAssignment
from repro_torch.optim import adam, warmup_cosine
from repro_torch.train import P2PTrainer
from repro_torch.train import checkpoint as ck
from test_torch_train_steps import fill_params

torch.set_num_threads(2)  # the test workers share the CPU with each other

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


class FakeMesh:
    """A mesh's axis sizes: all the reference trainer's accounting reads."""

    def __init__(self, peers):
        self.shape = {"data": peers, "model": 1}
        self.axis_names = tuple(self.shape)


def _cnn_loss(params, batch):  # the port's trainer needs one for a CNN; never called here
    raise AssertionError("not stepped")


def _pair(arch, peers=4, *, exchange="allgather_mean", graph="full", **kw):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if cfg.family != "cnn":
        jcfg, cfg = jreduced(jcfg), reduced(cfg)
    q = dict(levels=127, bucket=512)
    jtopo = JTopology(peer_axes=("data",), lambda_axis=None, exchange=exchange, graph=graph,
                      qsgd=JQ(**q) if exchange == "qsgd" else None)
    topo = Topology(exchange=exchange, graph=graph, qsgd=QSGDConfig(**q) if exchange == "qsgd" else None)
    sched = lambda s: 1e-3
    ref = JP2PTrainer(jcfg, jadam(), jtopo, FakeMesh(peers), sched, **kw)
    port = P2PTrainer(cfg, adam(), topo, peers, warmup_cosine(1e-3, 1, 4), device="cpu",
                      loss_fn=_cnn_loss if cfg.family == "cnn" else None, **kw)
    return ref, port


def _fields(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


CASES = [
    ("squeezenet1.1", "allgather_mean", "full"),
    ("squeezenet1.1", "psum_mean", "full"),
    ("squeezenet1.1", "qsgd", "full"),
    ("squeezenet1.1", "topk", "ring"),
    ("squeezenet1.1", "async", "gossip:2"),
    ("squeezenet1.1", "trimmed_mean:0.25", "full"),
    ("squeezenet1.1", "reduce_scatter", "full"),
    ("squeezenet1.1", "tree:2", "full"),
    ("qwen2.5-3b", "allgather_mean", "full"),
    ("qwen2.5-3b", "allgather_mean", "hierarchical:2"),
    ("qwen2.5-3b", "reduce_scatter", "full"),
]


@pytest.mark.parametrize("arch,exchange,graph", CASES)
def test_wire_cost_model_bytes_and_shard_plan_match_reference(arch, exchange, graph):
    ref, port = _pair(arch, exchange=exchange, graph=graph)
    assert port.num_peers == ref.num_peers == 4
    assert port.graph.describe() == ref.graph.describe()
    assert port.model_bytes == ref.model_bytes
    assert port.wire_bytes_per_step() == ref.wire_bytes_per_step()
    assert _fields(port.comm_cost()) == _fields(ref.comm_cost())
    assert port.comm_cost().summary() == ref.comm_cost().summary()
    plan, jplan = port.shard_plan(), ref.shard_plan()
    assert (plan is None) == (jplan is None)
    if plan is not None:
        assert plan.describe() == jplan.describe()
        assert (plan.num_shards, plan.shard_size, plan.pad) == (jplan.num_shards, jplan.shard_size,
                                                               jplan.pad)


@pytest.mark.parametrize("exchange", ["qsgd", "topk"])
def test_lm_codec_bytes_count_the_ports_per_layer_leaves(exchange):
    ref, port = _pair("qwen2.5-3b", exchange=exchange)
    own = port.protocol.wire_bytes(port._params_like(), port.ctx)
    assert port.wire_bytes_per_step() == own
    assert port.model_bytes == ref.model_bytes
    # the same payload up to the padding and rounding of the split leaves
    assert abs(own - ref.wire_bytes_per_step()) <= 0.05 * ref.wire_bytes_per_step()


TIMES = [0.31, 0.52, 0.47, 1.21, 0.66, 0.18]


@pytest.mark.parametrize("arch,exchange", [("squeezenet1.1", "reduce_scatter"),
                                           ("qwen2.5-3b", "allgather_mean")])
def test_accounting_matches_reference(arch, exchange):
    kw = dict(scheduler="pareto_walk", allocation="latency")
    ref, port = _pair(arch, exchange=exchange, **kw)
    for _ in range(2):  # warm pools and VM state persist across calls
        assert _fields(port.account_serverless(TIMES, epoch=0)) == \
            _fields(ref.account_serverless(TIMES, epoch=0))
        assert _fields(port.account_instance(TIMES, epoch=0, charge_exchange=True)) == \
            _fields(ref.account_instance(TIMES, epoch=0, charge_exchange=True))
        assert _fields(port.account(TIMES, batch_bytes=4096)) == \
            _fields(ref.account(TIMES, batch_bytes=4096))
    fr, jfr = port.cost_frontier(TIMES), ref.cost_frontier(TIMES)
    assert {k: _fields(v) for k, v in fr.items()} == {k: _fields(v) for k, v in jfr.items()}
    half = lambda A: [A("serverless")] * 2 + [A("instance", instance="t2.large")] * 2
    plan, jplan = FleetPlan(half(PeerAssignment)), JFleetPlan(half(JPeerAssignment))
    per_peer = [TIMES, TIMES[::-1], TIMES[1:], TIMES[:-1]]
    assert _fields(port.account_fleet(plan, per_peer, epoch=0)) == \
        _fields(ref.account_fleet(jplan, per_peer, epoch=0))
    pick, jpick = (t.schedule_epoch(per_peer, deadline_s=30.0) for t in (port, ref))
    assert pick["index"] == jpick["index"] and pick["plan"].describe() == jpick["plan"].describe()
    assert [_fields(r) for r in pick["candidates"]] == [_fields(r) for r in jpick["candidates"]]
    if exchange == "reduce_scatter":
        assert _fields(port.account_aggregation(epoch=0)) == _fields(ref.account_aggregation(epoch=0))
    else:
        for t in (port, ref):
            with pytest.raises(ValueError, match="is not sharded"):
                t.account_aggregation()


def test_trainer_refusals():
    cfg = reduced(get_config("qwen2.5-3b"))
    # MoE is ported: the capacity dispatch builds; on a MoE config an unknown
    # dispatch raises the reference's ValueError (its moe_apply's) at the step
    P2PTrainer(cfg, adam(), Topology(), 2, lambda s: 1e-3, moe_dispatch="capacity", device="cpu")
    moe = reduced(get_config("granite-moe-3b-a800m"), num_layers=1)
    trainer = P2PTrainer(moe, adam(), Topology(), 2, lambda s: 1e-3, moe_dispatch="sorted",
                         device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    toks = torch.randint(0, moe.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="unknown moe dispatch 'sorted'"):
        trainer.step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    with pytest.raises(ValueError, match="backend must be"):
        P2PTrainer(cfg, adam(), Topology(), 2, lambda s: 1e-3, backend="tpu", device="cpu")
    with pytest.raises(ValueError, match="no scheduler configured"):
        P2PTrainer(cfg, adam(), Topology(), 2, lambda s: 1e-3, device="cpu").schedule_epoch([[1.0]])


@pytest.mark.parametrize("exchange,graph,ef,banked", [
    ("allgather_mean", "full", False, False), ("qsgd", "full", True, False),
    ("async", "full", False, True), ("allgather_mean", "ring", True, True)])
def test_init_state_builds_the_mailbox_ef_bank_and_peer_bank(exchange, graph, ef, banked):
    cfg = reduced(get_config("qwen2.5-3b"))
    topo = Topology(exchange=exchange, graph=graph, ef=ef,
                    qsgd=QSGDConfig() if exchange == "qsgd" else None)
    trainer = P2PTrainer(cfg, adam(), topo, 4, lambda s: 1e-3, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    assert (state.mailbox is not None) == (exchange == "async")
    assert (state.ef is not None) == ef
    assert trainer.banked == banked
    name = next(iter(state.ef or state.params))
    if banked:
        assert state.params.num_peers == 4 and state.opt_state["mu"].num_peers == 4
    if ef:
        assert state.ef[name].shape == (4, *trainer._params_like()[name].shape)
    one = P2PTrainer(cfg, adam(), topo, 1, lambda s: 1e-3, device="cpu").init_state(
        torch.Generator().manual_seed(0))
    assert one.mailbox is None and one.ef is None  # the reference's single worker


# ---------------------------------------------------------------------------
# steps against the reference's trainer, in a 2-device subprocess
# ---------------------------------------------------------------------------

PEERS, STEPS, LR = 2, 2, 3e-3
RUNS = {"mean": {}, "clip": {"grad_clip": 1.0}}

REFERENCE = inspect.getsource(fill_params) + textwrap.dedent(
    """
    import os, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro.configs import get_config, reduced
    from repro.core.p2p import Topology
    from repro.optim import adam
    from repro.optim.schedules import warmup_cosine
    from repro.train import P2PTrainer

    out, runs = sys.argv[1], eval(sys.argv[2])
    cfg = reduced(get_config("qwen2.5-3b"), dtype="float32", remat=True)
    mesh = compat.make_mesh((2,), ("data",), axis_types=(compat.AxisType.Auto,))
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, cfg.vocab_size, size=(4, 17)).astype(np.int32) for _ in range(2)]
    np.save(os.path.join(out, "batches.npy"), np.stack(batches))
    for name, kw in runs.items():
        topo = Topology(peer_axes=("data",), lambda_axis=None, exchange="allgather_mean", **kw)
        trainer = P2PTrainer(cfg, adam(), topo, mesh, warmup_cosine(3e-3, 0, 4))
        state = trainer.init_state(jax.random.PRNGKey(0))
        state = state.replace(params=fill_params(cfg))
        state = state.replace(opt_state=trainer.optimizer.init(state.params))
        trainer.save(os.path.join(out, name + "_init"), state)
        losses, aux = [], []
        with compat.set_mesh(mesh):
            for toks in batches:
                state, m = trainer.step(state, {"tokens": jnp.asarray(toks[:, :-1]),
                                                "labels": jnp.asarray(toks[:, 1:])})
                losses.append(float(m["loss"]))
                aux.append(float(m["aux"]))
        trainer.save(os.path.join(out, name + "_final"), state)
        np.savez(os.path.join(out, name + "_metrics.npz"), loss=losses, aux=aux)
    print("OK")
    """
)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("trainer")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={PEERS}",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(out), repr(RUNS)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    return out


@pytest.mark.parametrize("run", sorted(RUNS))
def test_steps_from_the_references_checkpoint_match(reference, run):
    cfg = reduced(get_config("qwen2.5-3b"), dtype="float32", remat=True)
    topo = Topology(exchange="allgather_mean", **RUNS[run])
    trainer = P2PTrainer(cfg, adam(), topo, PEERS, warmup_cosine(LR, 0, 4), device="cpu")
    state = trainer.restore(str(reference / f"{run}_init"))
    assert state.step == 0 and int(state.opt_state["t"]) == 0
    batches = np.load(reference / "batches.npy")
    losses, aux = [], []
    for toks in batches:
        toks = torch.from_numpy(toks).long()
        state, metrics = trainer.step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        assert metrics["aux"].shape == (PEERS,)
        losses.append(float(metrics["loss"]))
        aux.append(float(metrics["aux"][0]))  # peer 0's: what the reference's replicated aux reads
    with np.load(reference / f"{run}_metrics.npz") as m:
        np.testing.assert_allclose(losses, m["loss"], rtol=1e-5)
        np.testing.assert_allclose(aux, m["aux"], rtol=1e-5)
    want, _ = ck.restore_state(str(reference / f"{run}_final"),
                               trainer.init_state(torch.Generator().manual_seed(1)), cfg=cfg)
    assert state.step == want.step == STEPS
    n_all = sum(p.numel() for p in want.params.values())
    n_far = sum(int(((state.params[k] - w).abs() > 2e-6).sum()) for k, w in want.params.items())
    worst = max(float((state.params[k] - w).abs().max()) for k, w in want.params.items())
    assert n_far <= 1e-3 * n_all, f"{n_far} of {n_all} params beyond 2e-6"
    assert worst <= LR * STEPS, f"params gap {worst:.3e}"
    for which in ("mu", "nu"):
        for k, w in want.opt_state[which].items():
            err = float((state.opt_state[which][k] - w).abs().max())
            assert err <= 5e-4 * float(w.abs().max()) + 1e-12, f"{which} {k}: {err:.3e}"


def test_shape_configs_are_the_references():
    from repro.configs import SHAPES as JSHAPES
    from repro_torch.configs import SHAPES, TRAIN_4K

    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert SHAPES["train_4k"] is TRAIN_4K


def test_full_width_qwen_exceeds_a_lambda_on_both_sides():
    """qwen2.5-3b at full width (model bytes from meta shapes on both
    sides): 13.6 GB of f32 params need 27,904 MB of Lambda memory, and the
    serverless accounting and the cost frontier refuse it with the
    reference's message; the instance baseline prices it."""
    jcfg, cfg = jget_config("qwen2.5-3b"), get_config("qwen2.5-3b")
    jtopo = JTopology(peer_axes=("data",), lambda_axis=None)
    ref = JP2PTrainer(jcfg, jadam(), jtopo, FakeMesh(2), lambda s: 1e-3)
    port = P2PTrainer(cfg, adam(), Topology(), 2, lambda s: 1e-3, device="cpu")
    assert port.model_bytes == ref.model_bytes == 4 * 3_397_627_904
    for call in (lambda t: t.account_serverless(TIMES), lambda t: t.cost_frontier(TIMES)):
        messages = []
        for t in (port, ref):
            with pytest.raises(ValueError, match="Lambda cap") as e:
                call(t)
            messages.append(str(e.value))
        assert messages[0] == messages[1] == "workload needs 27904 MB > Lambda cap 10240 MB"
    assert _fields(port.account_instance(TIMES, epoch=0, charge_exchange=True)) == \
        _fields(ref.account_instance(TIMES, epoch=0, charge_exchange=True))
