"""The port's device train step against the reference's, on the CPU.

Three steps of ``build_p2p_train_step`` on squeezenet1.1 (MNIST-shaped 8x8,
4 peers x batch 8, SGD with momentum from a non-zero momentum state) for
``allgather_mean``, ``qsgd(7, 256)`` with EF and ``topk(0.05)`` with EF.
The reference step runs once, in a subprocess with four host devices (its
``shard_map`` needs a mesh), and writes its inputs and results to npz; the
port starts from the same params and optimizer state (``convert``) and,
for QSGD, draws the reference's uniforms: step s, peer p, leaf i take
``uniform(split(fold_in(fold_in(key, s), p), L)[i])``.

Tolerances, as in ``test_torch_cluster_qsgd.py``: XLA and oneDNN sum
convolution gradients in another order, so params, momentum and EF
residuals agree within 1e-5, and losses within rtol 1e-5, except where a
boundary flip explains the gap, on at most 1e-4 of all coordinates:

* QSGD: a gradient element whose rounding fraction lies within ~1e-6 of
  its uniform may round the other way, moving one decoded element by
  ``norm / s``;
* top-k: where the k-th and (k+1)-th magnitudes of a leaf lie within the
  two gradients' difference (a relative gap of 8e-7 occurs in this run),
  the two sides keep different entries, moving one decoded element by
  about the k-th magnitude.

Momentum carries such a move into the later steps, so the gap may reach
``(1 + 0.9 + 0.81) * lr * flip`` in params, ``2.71 * flip`` in momentum
and ``flip`` in the EF residual, with ``flip`` the largest ``norm / s`` or
k-th magnitude of the run. The reference selects top-k with
``lax.top_k``; on distinct magnitudes that is the set the port's (the
Pallas kernel's) bisection picks.

Also here: the conversion of optimizer states, the train state's dict
access, ``exchange_gradients`` and the reference's ``ValueError`` refusals
of the step.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core.p2p import TrainState as JTrainState
from repro.train.checkpoint import _flatten
from repro_torch import convert, models
from repro_torch.configs import get_config
from repro_torch.core import compression as C
from repro_torch.core import p2p
from repro_torch.core.simulate import cnn_loss
from repro_torch.data import make_dataset
from repro_torch.kernels import topk as K
from repro_torch.optim import adam, sgd

torch.set_num_threads(2)  # the test workers share the CPU with each other

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
PEERS, LR, STEPS = 4, 0.05, 3
CASES = {
    "allgather": dict(exchange="allgather_mean"),
    "qsgd_ef": dict(exchange="qsgd", qsgd=(7, 256), ef=True),
    "topk_ef": dict(exchange="topk", topk_frac=0.05, ef=True),
}

REFERENCE = textwrap.dedent(
    """
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro.configs import get_config
    from repro.core.compression import QSGDConfig
    from repro.core.p2p import Topology, TrainState, build_p2p_train_step, init_ef
    from repro.core.simulate import cnn_loss
    from repro.data import BatchKey, DataLoader, Partitioner, make_dataset
    from repro.models import init_model
    from repro.optim import sgd
    from repro.train.checkpoint import _flatten

    out_path, peers, lr, steps, cases = sys.argv[1], 4, 0.05, 3, eval(sys.argv[2])
    ds = make_dataset("mnist", size=128, image_hw=8, channels=1)
    cfg = dataclasses.replace(get_config("squeezenet1.1"), image_size=8,
                              image_channels=1, num_classes=ds.num_classes)
    params = init_model(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    mom = jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32) * 1e-3), params)
    loader = DataLoader(Partitioner(ds, 1, shuffle_seed=0), 0, peers * 8)
    batches = [loader.load(BatchKey(0, 0, i)) for i in range(steps)]
    out = {f"init/{k}": v for k, v in _flatten(params).items()}
    out.update({f"mom0/{k}": v for k, v in _flatten(mom).items()})
    for i, b in enumerate(batches):
        out[f"batch{i}/images"], out[f"batch{i}/labels"] = b["images"], b["labels"]

    mesh = compat.make_mesh((peers,), ("data",), axis_types=(compat.AxisType.Auto,))
    opt = sgd(momentum=0.9)
    loss_fn = lambda p, b: cnn_loss(p, b, cfg)
    for name, kw in cases.items():
        kw = dict(kw)
        if "qsgd" in kw:
            kw["qsgd"] = QSGDConfig(*kw["qsgd"])
        topo = Topology(peer_axes=("data",), lambda_axis=None, **kw)
        step = jax.jit(build_p2p_train_step(loss_fn, opt, topo, mesh, lambda s: lr))
        st = TrainState(params=params, opt_state=mom, step=jnp.zeros((), jnp.int32),
                        key=jax.random.PRNGKey(0))
        if topo.ef:
            st = st.replace(ef=init_ef(params, peers))
        losses = []
        with compat.set_mesh(mesh):
            for b in batches:
                st, m = step(st, jax.tree.map(jnp.asarray, b))
                losses.append(float(m["loss"]))
        out.update({f"{name}/params/{k}": v for k, v in _flatten(st.params).items()})
        out.update({f"{name}/momentum/{k}": v for k, v in _flatten(st.opt_state).items()})
        if st.ef is not None:
            out.update({f"{name}/ef/{k}": v for k, v in _flatten(st.ef).items()})
        out[f"{name}/loss"] = np.asarray(losses)
    np.savez(out_path, **out)
    print("OK")
    """
)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("p2p") / "reference.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path), repr(CASES)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    with np.load(path) as npz:
        data = dict(npz)
    return lambda prefix: {k[len(prefix) + 1:]: v for k, v in data.items()
                           if k.startswith(prefix + "/")}


def _model():
    ds = make_dataset("mnist", size=128, image_hw=8, channels=1)
    cfg = dataclasses.replace(get_config("squeezenet1.1"), image_size=8, image_channels=1,
                              num_classes=ds.num_classes)
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    return model.requires_grad_(False)


def _replay_step_uniforms(monkeypatch, num_leaves):
    """The reference's QSGD uniforms for consecutive steps from key 0."""
    def stream():
        for s in range(STEPS):
            step_key = jax.random.fold_in(jax.random.PRNGKey(0), s)
            per_peer = [jax.random.split(jax.random.fold_in(step_key, p), num_leaves)
                        for p in range(PEERS)]
            for i in range(num_leaves):
                yield [keys[i] for keys in per_peer]

    keys = stream()

    def draw(shape, generator):
        peers, nb, bucket = shape
        u = [np.asarray(jax.random.uniform(k, (nb, bucket), jnp.float32)) for k in next(keys)]
        return torch.from_numpy(np.stack(u))

    monkeypatch.setattr(C, "draw_uniforms", draw)


def _stacked_to_jax(bank):
    return {convert.jax_path(k): convert.to_jax_layout(v, lead=1).numpy()
            for k, v in bank.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_reference(reference, monkeypatch, case):
    kw = dict(CASES[case])
    if "qsgd" in kw:
        kw["qsgd"] = C.QSGDConfig(*kw["qsgd"])
    topo = p2p.Topology(**kw)
    model = _model()
    loss_fn = lambda params, batch: cnn_loss(model, params, batch["images"], batch["labels"])
    opt = sgd(momentum=0.9)
    step = p2p.build_p2p_train_step(loss_fn, opt, topo, PEERS, lambda s: LR, device="cpu")
    params = convert.from_jax(reference("init"), device="cpu")
    state = p2p.TrainState(
        params=params, opt_state=convert.opt_state_from_jax(reference("mom0"), device="cpu"),
        step=0, key=torch.Generator().manual_seed(0),
    )
    flips = [0.0]  # the most one boundary flip can move a decoded element
    if topo.exchange == "qsgd":
        _replay_step_uniforms(monkeypatch, len(params))
        reduce = C.dequant_reduce
        monkeypatch.setattr(C, "dequant_reduce", lambda lev, nrm, *a: (
            flips.append(float(nrm.max()) / topo.qsgd.levels), reduce(lev, nrm, *a))[1])
    if topo.exchange == "topk":
        select = K.topk_select_pack
        monkeypatch.setattr(K, "topk_select_pack", lambda x, k: (
            lambda v, i: (flips.append(float(v.abs().min())), (v, i))[1])(*select(x, k)))
    losses = []
    for i in range(STEPS):
        b = reference(f"batch{i}")
        batch = {"images": models.images_to_device(b["images"], "cpu"),
                 "labels": torch.from_numpy(b["labels"].astype(np.int64))}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        assert metrics["grad_norm"].shape == metrics["aux"].shape == (PEERS,)
    assert state.step == STEPS
    np.testing.assert_allclose(losses, reference(case)["loss"], rtol=1e-5)

    pairs = [
        (convert.to_jax(state.params), reference(f"{case}/params"), "params"),
        (convert.opt_state_to_jax(state.opt_state), reference(f"{case}/momentum"), "momentum"),
    ]
    if topo.ef:
        pairs.append((_stacked_to_jax(state.ef), reference(f"{case}/ef"), "ef"))
    else:
        assert state.ef is None and not reference(f"{case}/ef")
    flip = {"params": 2.71 * LR * max(flips), "momentum": 2.71 * max(flips), "ef": max(flips)}
    for ours, theirs, what in pairs:
        assert sorted(ours) == sorted(theirs), what
        gaps = np.concatenate([np.abs(ours[k] - theirs[k]).reshape(-1) for k in theirs])
        assert gaps.max() <= flip[what] + 1e-5, (what, gaps.max())
        assert (gaps > 1e-5).sum() <= 1e-4 * gaps.size, (what, (gaps > 1e-5).sum())


@pytest.mark.parametrize("make", [lambda: joptim.sgd(momentum=0.9), joptim.adam])
def test_optimizer_state_converts_both_ways(make):
    """A reference state after one update, carried into the port and back,
    is unchanged; one more update from it agrees on both sides."""
    rng = np.random.default_rng(0)
    jparams = {"conv": {"w": jnp.asarray(rng.normal(size=(3, 3, 2, 4)).astype(np.float32))},
               "fc": {"w": jnp.asarray(rng.normal(size=(5, 6)).astype(np.float32)),
                      "b": jnp.asarray(rng.normal(size=6).astype(np.float32))}}
    jopt = make()
    jgrads = [jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)),
                           jparams) for _ in range(2)]
    _, jstate = jopt.update(jgrads[0], jopt.init(jparams), jparams, 0.1)
    flat = _flatten(jstate)
    state = convert.opt_state_from_jax(flat, device="cpu")
    back = convert.opt_state_to_jax(state)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])

    opt = adam() if "t" in flat else sgd(momentum=0.9)
    params = convert.from_jax(_flatten(jparams), device="cpu")
    grads = convert.from_jax(_flatten(jgrads[1]), device="cpu")
    _, state = opt.update(grads, state, params, 0.1)
    _, jstate = jopt.update(jgrads[1], jstate, jparams, 0.1)
    ours, theirs = convert.opt_state_to_jax(state), _flatten(jstate)
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_train_state_dict_access_is_the_reference():
    kw = dict(params={"w": 1}, opt_state={}, step=0, key=None)
    ours, theirs = p2p.TrainState(**kw), JTrainState(**kw)
    for a, b in ((ours, theirs), (ours.replace(ef={"w": 2}), theirs.replace(ef={"w": 2}))):
        assert a.keys() == b.keys() and list(a) == list(b)
        assert ("ef" in a) == ("ef" in b) and a.get("ef") == b.get("ef")
        assert a.get("mailbox", 5) == b.get("mailbox", 5) == 5
    with pytest.raises(KeyError):
        ours["ef"]
    assert p2p.as_train_state(dict(kw)) == ours
    with pytest.raises(ValueError, match="cannot carry"):
        p2p.as_train_state(dict(kw, extra=1))


def test_exchange_gradients_is_the_protocols_combine():
    g = {"w": torch.randn(PEERS, 3, 5, generator=torch.Generator().manual_seed(0))}
    avg, mailbox = p2p.exchange_gradients(g, p2p.Topology(), num_peers=PEERS)
    assert mailbox is None
    torch.testing.assert_close(avg["w"], g["w"].mean(0).expand(PEERS, 3, 5), rtol=0, atol=0)
    with pytest.raises(ValueError, match="stacks 4 peers"):
        p2p.exchange_gradients(g, p2p.Topology(), num_peers=3)


def _build(topo, **kw):
    return p2p.build_p2p_train_step(lambda p, b: None, sgd(), topo, PEERS, lambda s: LR,
                                    device=kw.pop("device", "cpu"), **kw)


@pytest.mark.parametrize("topo,kw,match", [
    (p2p.Topology(exchange="krum", graph="ring"), {}, "graph='full'"),
    (p2p.Topology(exchange="reduce_scatter", graph="ring"), {}, "graph='full'"),
    (p2p.Topology(exchange="tree:3", graph="gossip:2"), {}, "graph='full'"),
    (p2p.Topology(), dict(adversary="stale_replay"), "host mailbox path"),
    (p2p.Topology(exchange="trimmed_mean:0.5"), {}, r"\[0, 0.5\)"),
    (p2p.Topology(exchange="krum:0"), {}, "selection count must be >= 1"),
    (p2p.Topology(exchange="tree:1"), {}, "fanout must be >= 2"),
])
def test_the_references_refusals_are_kept(topo, kw, match):
    """What the reference's device step refuses, the port's refuses with the
    same ``ValueError``."""
    from repro_torch.core import AdversarySpec

    if "adversary" in kw:
        kw = dict(adversary=AdversarySpec(num=1, attack=kw["adversary"]))
    with pytest.raises(ValueError, match=match):
        _build(topo, **kw)


def test_async_ring_rolls_through_exchange_gradients():
    """``init_mailbox`` is the reference's zero ring, ``(K, P, *shape)`` f32;
    ``exchange_gradients`` with the ``async`` protocol mixes the bank
    published K steps ago (zeros for the first K) with each peer's fresh
    gradient and rolls the ring by one."""
    from repro.core.p2p import init_mailbox as jinit_mailbox

    K = 2
    rng = np.random.default_rng(0)
    like = {"a": np.zeros((3, 2), np.float32), "b": np.zeros((5,), np.float32)}
    ring = p2p.init_mailbox({k: torch.from_numpy(v) for k, v in like.items()}, PEERS,
                            staleness=K)
    theirs = jinit_mailbox({k: jnp.asarray(v) for k, v in like.items()}, PEERS, staleness=K)
    for k, v in ring.items():
        assert v.dtype == torch.float32 and v.shape == theirs[k].shape == (K, PEERS, *like[k].shape)
        assert not v.any()
    topo = p2p.Topology(exchange="async", staleness=K)
    banks = [{k: torch.from_numpy(rng.normal(size=(PEERS, *v.shape)).astype(np.float32))
              for k, v in like.items()} for _ in range(K + 2)]
    for t, bank in enumerate(banks):
        mixed, ring = p2p.exchange_gradients(bank, topo, mailbox=ring)
        stale = banks[t - K] if t >= K else {k: torch.zeros_like(v) for k, v in bank.items()}
        for k, g in bank.items():
            others = stale[k].sum(0) - stale[k]
            torch.testing.assert_close(mixed[k], (others + g) / PEERS, rtol=0, atol=1e-6)
            torch.testing.assert_close(ring[k][-1], g, rtol=0, atol=0)
            torch.testing.assert_close(ring[k][0], banks[t - 1][k] if t >= 1 else
                                       torch.zeros_like(g), rtol=0, atol=0)


def test_step_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="graph='full'"):
        _build(p2p.Topology(exchange="psum_mean", graph="ring"))
    with pytest.raises(ValueError, match="not a torch dtype"):
        _build(p2p.Topology(exchange_dtype="float8"))
    with pytest.raises(ValueError, match="accum_steps"):
        _build(p2p.Topology(accum_steps=0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            p2p.build_p2p_train_step(lambda p, b: None, sgd(), p2p.Topology(), PEERS,
                                     lambda s: LR)


def test_accumulation_and_clipping_match_the_plain_formulas():
    """accum_steps averages the micro-round gradients; grad_clip clips each
    peer's gradient to the global norm; EF on a lossless protocol keeps a
    zero residual and changes nothing."""
    torch.manual_seed(0)
    w0 = torch.randn(3, 4)
    x = torch.randn(PEERS * 4, 4)
    loss_fn = lambda p, b: (((b["x"] @ p["w"].T) ** 2).mean(), b["x"].sum())

    def run(**kw):
        step = p2p.build_p2p_train_step(loss_fn, sgd(), p2p.Topology(**kw), PEERS,
                                        lambda s: 0.1, device="cpu")
        st, m = step(p2p.TrainState({"w": w0}, {}, 0, None), {"x": x})
        return st, m

    def peer_grad(rows):
        w = w0.clone().requires_grad_(True)
        (((rows @ w.T) ** 2).mean()).backward()
        return w.grad

    per_peer = [peer_grad(x[4 * r:4 * r + 4]) for r in range(PEERS)]
    st, m = run()
    torch.testing.assert_close(st.params["w"], w0 - 0.1 * torch.stack(per_peer).mean(0))
    micro = [(peer_grad(x[4 * r:4 * r + 2]) + peer_grad(x[4 * r + 2:4 * r + 4])) / 2
             for r in range(PEERS)]
    st, _ = run(accum_steps=2)
    torch.testing.assert_close(st.params["w"], w0 - 0.1 * torch.stack(micro).mean(0))
    st, m = run(grad_clip=0.5)
    norms = torch.stack([g.norm() for g in per_peer])
    torch.testing.assert_close(m["grad_norm"], norms)
    clipped = [g * min(1.0, 0.5 / float(n)) for g, n in zip(per_peer, norms)]
    torch.testing.assert_close(st.params["w"], w0 - 0.1 * torch.stack(clipped).mean(0))
    st, _ = run(ef=True)
    assert not st.ef["w"].any() and st.ef["w"].shape == (PEERS, 3, 4)
    torch.testing.assert_close(st.params["w"], w0 - 0.1 * torch.stack(per_peer).mean(0))
