"""The P2P step's profiler ranges (``p2p.STEP_SPANS``), on the CPU.

Each call of ``build_p2p_train_step``'s step opens ``repro_torch.step``,
with the step number as its input, and inside it, disjoint and in order,
``compute_gradients``, ``exchange`` (not on the fused plain mean, which has
none) and ``model_update``. The ranges change no number: two steps give the
same bits with a profiler listening and without one. They are host ranges,
not user annotations, so the profiler projects none of them onto the card.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import compression as C
from repro_torch.core import p2p
from repro_torch.optim import adam

torch.set_num_threads(2)  # the test workers share the CPU with each other

PEERS, STEPS = 4, 2
STEP, GRAD, EXCHANGE, UPDATE = p2p.STEP_SPANS

PATHS = {
    "plain_mean": p2p.Topology(),
    "qsgd_ef": p2p.Topology(exchange="qsgd", ef=True, qsgd=C.QSGDConfig(levels=15, bucket=16)),
    "topk": p2p.Topology(exchange="topk", topk_frac=0.25),
    "ring_bank": p2p.Topology(graph="ring"),
}


def mlp_loss(p, b):
    h = torch.tanh(b["x"] @ p["l1.w"].T + p["l1.b"])
    o = h @ p["l2.w"].T + p["l2.b"]
    return ((o - b["y"]) ** 2).mean(), h.abs().mean()


def run_steps(topo):
    """``STEPS`` steps of the path from one seed -> (final state, losses)."""
    rng = np.random.default_rng(0)
    r = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.3).astype(np.float32))
    params = {"l1.w": r(16, 8), "l1.b": r(16), "l2.w": r(3, 16), "l2.b": r(3)}
    batches = [{"x": r(PEERS * 3, 8), "y": r(PEERS * 3, 3)} for _ in range(STEPS)]
    opt = adam()
    opt_state = opt.init(params)
    step = p2p.build_p2p_train_step(mlp_loss, opt, topo, PEERS, lambda s: 0.05, device="cpu")
    if topo.graph != "full":
        params, opt_state = p2p.peer_bank(params, opt_state, PEERS)
    state = p2p.TrainState(params, opt_state, 0, torch.Generator().manual_seed(1))
    losses = []
    for batch in batches:
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    return state, losses


def leaves(tree, path=""):
    """{path: tensor} of every tensor in ``tree`` (params, moments, the EF
    bank), through dicts, ``PeerBank`` banks and the state's fields."""
    if isinstance(tree, p2p.TrainState):
        return leaves({"params": tree.params, "opt_state": tree.opt_state, "ef": tree.ef})
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in leaves(sub, f"{path}{key}/").items()}
    return {path: tree} if torch.is_tensor(tree) else {}


def ranges(prof):
    """The program's ranges on the host: [(name, start_ns, end_ns, inputs)]
    in order of their start."""
    return sorted(((e.name(), e.start_ns(), e.end_ns(), e.concrete_inputs())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() in p2p.STEP_SPANS), key=lambda r: (r[1], -r[2]))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_each_step_opens_its_ranges_in_order(path):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        run_steps(PATHS[path])
    found = ranges(prof)
    stages = [GRAD, UPDATE] if path == "plain_mean" else [GRAD, EXCHANGE, UPDATE]
    assert [r[0] for r in found] == [STEP, *stages] * STEPS
    per_step = len(stages) + 1
    for i in range(STEPS):
        (name, s0, e0, inputs), *children = found[i * per_step:(i + 1) * per_step]
        assert inputs == [i]  # the step number: a step's ranges share it
        assert s0 <= children[0][1] and children[-1][2] <= e0
        for a, b in zip(children, children[1:]):
            assert a[2] <= b[1]  # disjoint, in order


@pytest.mark.parametrize("path", sorted(PATHS))
def test_ranges_change_no_number(path):
    plain, plain_losses = run_steps(PATHS[path])
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True):
        traced, traced_losses = run_steps(PATHS[path])
    for a, b in zip(plain_losses, traced_losses):
        assert torch.equal(a, b)
    a, b = leaves(plain), leaves(traced)
    assert a.keys() == b.keys() and any(k.startswith("opt_state/mu/") for k in a)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert plain.step == traced.step == STEPS


def test_a_tensor_step_is_left_out_of_the_range():
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with p2p._span(STEP, torch.tensor(3)):
            pass
        with p2p._span(STEP, np.int64(4)):
            pass
    assert [r[3] for r in ranges(prof)] == [[], [4]]


def test_the_ranges_are_host_ranges_with_one_prefix():
    """No range is a user annotation (which the profiler would project onto
    the card's timeline over the stage's kernels and idle gaps), and every
    name shares the step's prefix."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        run_steps(PATHS["qsgd_ef"])
    found = [e for e in prof.profiler.kineto_results.events() if e.name() in p2p.STEP_SPANS]
    assert {e.name() for e in found} == set(p2p.STEP_SPANS)
    assert not any(e.is_user_annotation() for e in found)
    assert all(e.device_type() == torch.autograd.DeviceType.CPU for e in found)
    assert all(name.startswith(p2p.STEP_SPANS[0] + ".") for name in p2p.STEP_SPANS[1:])
    assert len(set(p2p.STEP_SPANS)) == len(p2p.STEP_SPANS)
