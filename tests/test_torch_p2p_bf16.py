"""bf16 compute params on the device step, and the port's f32 numerics scope.

``Topology(cast_params_once=True)``: the reference casts every f32 leaf with
two or more dimensions to bf16 once per step and takes the gradients on
that copy; the master params, the optimizer state and the 1-d leaves stay
f32. Held here on a two-layer MLP whose layers cast their input to the
weight's dtype (the reference's CNNs cannot take the option: a bf16 kernel
against f32 images makes ``lax.conv_general_dilated`` raise, as the port's
``F.conv2d`` does; pinned below as reference behaviour 16). Four peers x
batch 8, SGD with momentum, 3 steps on the full graph (also with the
gradient clip, whose f32 scale promotes bf16 gradients to f32 as jnp
does) and on the ring, against the reference's step in a subprocess with four host devices (row r
of the port's bank against mesh device r's buffer on the ring). On the
full graph without the clip the step makes no bank: it takes one gradient
of the peers' mean loss, whose bf16 weight gradients are the peers' sum
rounded once, and ``max|g|`` below is then that of the mean it hands the
update (no larger than the bank's).

Tolerance: both sides round the same bf16 products, but XLA and oneDNN
accumulate them in other orders, so a bf16 activation or gradient may land
one bf16 ulp (2^-8 relative) apart. A gradient element moves by at most
``2^-7 |g|``; momentum carries that through three steps
(``1 + 1.9 + 2.71 <= 5.61`` times ``lr``), so params agree within
``5.61 * lr * 2^-7 * max|g| + 1e-6`` and losses within rtol 2^-7.

The f32 numerics scope (``models.cnn.f32_numerics``): it sets and restores
the cuDNN and matmul flags, also when its body raises; the cluster's
gradient and evaluation, the device step's per-peer gradients and the
overlay mixes run inside it whatever the caller's global flags. On the
card (skipped here): a seeded mobilenet QSGD cluster run twice under
PyTorch's default flags gives bit-identical params, and a conv gradient
is bit-identical with the global TF32 flag on and off.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import LocalP2PCluster, QSGDConfig, p2p
from repro_torch.core.exchange import AllGatherMean
from repro_torch.core.simulate import cnn_loss
from repro_torch.data import BatchKey, make_dataset
from repro_torch.models.cnn import f32_numerics
from repro_torch.optim import sgd
from test_torch_p2p import LR, PEERS, SRC, STEPS, _model

torch.set_num_threads(2)  # the test workers share the CPU with each other

CASES = {  # Topology fields besides cast_params_once=True
    "full": {},
    "ring": dict(graph="ring"),
    # the clip's f32 scale promotes the bf16 gradients to f32, as jnp does
    "full_clip": dict(grad_clip=0.5),
}

REFERENCE = textwrap.dedent(
    """
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro.configs import get_config
    from repro.core.p2p import Topology, TrainState, build_p2p_train_step
    from repro.core.simulate import cnn_loss
    from repro.data import BatchKey, DataLoader, Partitioner, make_dataset
    from repro.models import init_model
    from repro.optim import sgd
    from repro.train.checkpoint import _flatten

    out_path, peers, lr, steps, cases = sys.argv[1], 4, 0.05, 3, eval(sys.argv[2])
    din, dh, dout, b = 6, 16, 3, 8
    rng = np.random.default_rng(0)
    params = {"l1": {"w": rng.normal(size=(din, dh)).astype(np.float32) * 0.5,
                     "b": rng.normal(size=dh).astype(np.float32) * 0.1},
              "l2": {"w": rng.normal(size=(dh, dout)).astype(np.float32) * 0.5,
                     "b": rng.normal(size=dout).astype(np.float32) * 0.1}}
    mom = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32) * 1e-2, params)
    batches = [{"x": rng.normal(size=(peers * b, din)).astype(np.float32),
                "y": rng.normal(size=(peers * b, dout)).astype(np.float32)} for _ in range(steps)]
    out = {f"init/{k}": v for k, v in _flatten(params).items()}
    out.update({f"mom0/{k}": v for k, v in _flatten(mom).items()})
    for i, bt in enumerate(batches):
        out.update({f"batch{i}/{k}": v for k, v in bt.items()})

    def mlp_loss(p, bt):
        h = jnp.tanh(bt["x"].astype(p["l1"]["w"].dtype) @ p["l1"]["w"] + p["l1"]["b"])
        o = h.astype(p["l2"]["w"].dtype) @ p["l2"]["w"] + p["l2"]["b"]
        return jnp.mean((o.astype(jnp.float32) - bt["y"]) ** 2), jnp.mean(jnp.abs(h))

    mesh = compat.make_mesh((peers,), ("data",), axis_types=(compat.AxisType.Auto,))
    place = {d: i for i, d in enumerate(mesh.devices.flat)}

    def per_device(tree):
        def rows(x):
            got = {place[s.device]: np.asarray(s.data) for s in x.addressable_shards}
            return np.stack([got[i] for i in range(peers)])
        return _flatten(jax.tree.map(rows, tree))

    opt = sgd(momentum=0.9)
    for name, kw in cases.items():
        topo = Topology(peer_axes=("data",), lambda_axis=None, cast_params_once=True, **kw)
        step = jax.jit(build_p2p_train_step(mlp_loss, opt, topo, mesh, lambda s: lr))
        st = TrainState(params=jax.tree.map(jnp.asarray, params), opt_state=mom,
                        step=jnp.zeros((), jnp.int32), key=jax.random.PRNGKey(0))
        losses = []
        with compat.set_mesh(mesh):
            for bt in batches:
                st, m = step(st, jax.tree.map(jnp.asarray, bt))
                losses.append(float(m["loss"]))
        jax.block_until_ready(st)
        out.update({f"{name}/params/{k}": v for k, v in per_device(st.params).items()})
        out.update({f"{name}/momentum/{k}": v for k, v in per_device(st.opt_state).items()})
        out[f"{name}/loss"] = np.asarray(losses)

    # the reference's CNNs refuse the option: bf16 kernels against f32 images
    ds = make_dataset("mnist", size=128, image_hw=8, channels=1)
    cfg = dataclasses.replace(get_config("squeezenet1.1"), image_size=8,
                              image_channels=1, num_classes=ds.num_classes)
    cnn = init_model(jax.random.PRNGKey(0), cfg)
    topo = Topology(peer_axes=("data",), lambda_axis=None, cast_params_once=True)
    step = jax.jit(build_p2p_train_step(lambda p, bt: cnn_loss(p, bt, cfg), opt, topo, mesh,
                                        lambda s: lr))
    bt = DataLoader(Partitioner(ds, 1, shuffle_seed=0), 0, peers * 8).load(BatchKey(0, 0, 0))
    try:
        with compat.set_mesh(mesh):
            step(TrainState(params=cnn, opt_state=opt.init(cnn), step=jnp.zeros((), jnp.int32),
                            key=jax.random.PRNGKey(0)), jax.tree.map(jnp.asarray, bt))
        out["cnn_error"] = np.asarray("")
    except TypeError as e:
        out["cnn_error"] = np.asarray(str(e))
    np.savez(out_path, **out)
    print("OK")
    """
)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("p2p_bf16") / "reference.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path), repr(CASES)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    with np.load(path) as npz:
        data = dict(npz)
    return data, lambda prefix: {k[len(prefix) + 1:]: v for k, v in data.items()
                                 if k.startswith(prefix + "/")}


def mlp_loss(p, b):
    """The reference's MLP: each layer casts its input to its weight's dtype."""
    h = torch.tanh(F.linear(b["x"].to(p["l1.w"].dtype), p["l1.w"]) + p["l1.b"])
    o = F.linear(h.to(p["l2.w"].dtype), p["l2.w"]) + p["l2.b"]
    return ((o.to(torch.float32) - b["y"]) ** 2).mean(), h.abs().mean()


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_compute_params_match_the_reference(reference, monkeypatch, case):
    data, part = reference
    topo = p2p.Topology(cast_params_once=True, **CASES[case])
    graph = topo.graph
    opt = sgd(momentum=0.9)
    params = convert.from_jax(part("init"), device="cpu")
    mom = convert.opt_state_from_jax(part("mom0"), device="cpu")
    grads = []  # every peer's gradient bank, as the step hands it to the exchange
    combine = AllGatherMean.combine
    monkeypatch.setattr(AllGatherMean, "combine", lambda self, g, *a, **kw: (
        grads.append(g), combine(self, g, *a, **kw))[1])
    means = []  # what the full graph's bank-free mean hands the update
    update = p2p._update_by_leaf
    monkeypatch.setattr(p2p, "_update_by_leaf", lambda opt, avg, *a: (
        means.append(dict(avg)), update(opt, avg, *a))[1])
    seen = []  # the dtypes of the params the loss computes with
    loss_fn = lambda p, b: (seen.append({k: v.dtype for k, v in p.items()}), mlp_loss(p, b))[1]
    step = p2p.build_p2p_train_step(loss_fn, opt, topo, PEERS, lambda s: LR, device="cpu")
    if graph != "full":
        params, mom = p2p.peer_bank(params, mom, PEERS)
    state = p2p.TrainState(params, mom, 0, None)
    losses = []
    for i in range(STEPS):
        b = part(f"batch{i}")
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    # the bf16 cast: the loss sees bf16 2-d weights and f32 biases; in a
    # bank their gradients come back bf16 (f32 after the clip's f32 scale),
    # the biases' f32. The full graph's plain mean makes no bank: one
    # gradient of the peers' mean loss, handed to the update in f32
    assert seen and all(d == {"l1.w": torch.bfloat16, "l1.b": torch.float32,
                              "l2.w": torch.bfloat16, "l2.b": torch.float32} for d in seen)
    if case == "full":
        assert grads == [] and len(means) == STEPS
        assert all(g.dtype == torch.float32 for m in means for g in m.values())
        grads = means
    else:
        weights = torch.float32 if topo.grad_clip else torch.bfloat16
        assert {k: g.dtype for k, g in grads[0].items()} == {
            "l1.w": weights, "l1.b": torch.float32, "l2.w": weights, "l2.b": torch.float32}
    assert all(v.dtype == torch.float32 for v in state.params.values())  # master params
    np.testing.assert_allclose(losses, data[f"{case}/loss"], rtol=2**-7)
    gmax = max(float(g.abs().max()) for bank in grads for g in bank.values())
    bound = 5.61 * LR * 2**-7 * gmax + 1e-6
    theirs = part(f"{case}/params")
    rows = [p2p.peer_row(state.params, r) if graph != "full" else state.params
            for r in range(PEERS)]
    for r, row in enumerate(rows):
        ours = convert.to_jax(row)
        gap = max(float(np.abs(ours[k] - theirs[k][r]).max()) for k in theirs)
        assert gap <= bound, (case, r, gap, bound)
    if graph == "full":  # the reference's replicated params are one copy there
        for k, v in theirs.items():
            assert all(np.array_equal(v[r], v[0]) for r in range(PEERS)), k


def test_cnns_refuse_bf16_compute_params_on_both_sides(reference):
    """Reference behaviour 16: a bf16 kernel against f32 images raises in
    the reference's convolution, and in the port's ``F.conv2d``."""
    data, _ = reference
    assert "conv_general_dilated requires arguments to have the same dtypes" in str(data["cnn_error"])
    model = _model()
    step = p2p.build_p2p_train_step(lambda p, b: cnn_loss(model, p, b["images"], b["labels"]),
                                    sgd(momentum=0.9), p2p.Topology(cast_params_once=True),
                                    PEERS, lambda s: LR, device="cpu")
    params = {k: v.clone() for k, v in model.named_parameters()}
    batch = {"images": torch.zeros(PEERS * 2, 1, 8, 8), "labels": torch.zeros(PEERS * 2, dtype=torch.long)}
    with pytest.raises(RuntimeError, match="(?i)type|dtype"):
        step(p2p.TrainState(params, sgd(momentum=0.9).init(params), 0, None), batch)


# ---------------------------------------------------------------------------
# The f32 numerics scope
# ---------------------------------------------------------------------------

SCOPE = {"cudnn.allow_tf32": False, "cudnn.deterministic": True, "cudnn.benchmark": False,
         "matmul.allow_tf32": False}


def _flags():
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn.deterministic": torch.backends.cudnn.deterministic,
            "cudnn.benchmark": torch.backends.cudnn.benchmark,
            "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}


@pytest.fixture
def loose_flags(monkeypatch):
    """The opposite of the scope's every flag, restored after the test."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    return _flags()


def test_the_scope_sets_the_flags_and_restores_the_callers(loose_flags):
    with f32_numerics():
        assert _flags() == SCOPE
    assert _flags() == loose_flags
    with pytest.raises(ZeroDivisionError):
        with f32_numerics():
            assert _flags() == SCOPE
            1 / 0
    assert _flags() == loose_flags


def _record(monkeypatch, module, name):
    """Wrap ``module.name`` to record the flags at each call."""
    seen, fn = [], getattr(module, name)

    def wrapped(*args, **kwargs):
        seen.append(_flags())
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)
    return seen


def test_the_cnn_and_the_mixes_run_inside_the_scope(loose_flags, monkeypatch):
    """Whatever the caller's global flags: the cluster's gradient and
    evaluation, the step's per-peer gradients (held once and banked) and
    the overlay mixes (``allgather_mean`` and ``async`` on the ring)."""
    convs = _record(monkeypatch, F, "conv2d")
    mixes = _record(monkeypatch, torch, "tensordot")
    ds = make_dataset("mnist", size=64, image_hw=8, channels=1)
    cl = LocalP2PCluster(get_config("squeezenet1.1"), ds, num_peers=2, batch_size=4,
                         batches_per_epoch=1, optimizer=sgd(), lr=0.05, seed=0, device="cpu")
    wb = cl._to_device(cl.peers[0].loader.load(BatchKey(0, 0, 0)))
    cl._grad(cl.peers[0].params, wb)
    cl._eval(cl.peers[0].params, wb)
    assert convs and all(f == SCOPE for f in convs)
    assert _flags() == loose_flags
    convs.clear()
    model = _model()
    one = {k: v.clone() for k, v in model.named_parameters()}
    batch = {"images": torch.randn(PEERS * 2, 1, 8, 8), "labels": torch.arange(PEERS * 2) % 10}
    for topo in (p2p.Topology(), p2p.Topology(graph="ring"),
                 p2p.Topology(exchange="async", graph="ring")):
        step = p2p.build_p2p_train_step(lambda p, b: cnn_loss(model, p, b["images"], b["labels"]),
                                        sgd(), topo, PEERS, lambda s: LR, device="cpu")
        params = one if topo.graph == "full" else p2p.peer_bank(one, {}, PEERS)[0]
        mailbox = p2p.init_mailbox(one, PEERS) if topo.exchange == "async" else None
        step(p2p.TrainState(params, {}, 0, None, mailbox=mailbox), batch)
    assert convs and all(f == SCOPE for f in convs)
    assert len(mixes) == 2 * len(one) and all(f == SCOPE for f in mixes)
    assert _flags() == loose_flags


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuDNN and the kernels run only there")


def test_cuda_seeded_cluster_repeats_itself_bit_for_bit(cuda):
    """A seeded mobilenet QSGD cluster, 4 peers, 2 epochs, run twice under
    PyTorch's default global flags: bit-identical params."""
    runs = []
    for _ in range(2):
        cl = LocalP2PCluster(get_config("mobilenet-v3-small"), make_dataset("cifar"), num_peers=4,
                             batch_size=32, batches_per_epoch=2, optimizer=sgd(momentum=0.9),
                             lr=0.01, exchange="qsgd", qsgd=QSGDConfig(127, 2048), seed=0)
        cl.run(2)
        runs.append([p.params for p in cl.peers])
    for a, b in zip(*runs):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_cuda_conv_gradient_ignores_the_global_tf32_flag(cuda, monkeypatch):
    cl = LocalP2PCluster(get_config("vgg11"), make_dataset("cifar"), num_peers=1, batch_size=32,
                         batches_per_epoch=1, optimizer=sgd(), lr=0.01, seed=0)
    batch = cl._to_device(cl.peers[0].loader.load(BatchKey(0, 0, 0)))
    grads = []
    for tf32 in (True, False):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", tf32)
        grads.append(cl._grad(cl.peers[0].params, batch)[0])
    assert all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])
