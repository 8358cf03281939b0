"""The port's per-peer device step against the reference's, on the CPU.

On a sparse overlay, and under ``async`` on any graph, each peer's mix
differs. The reference's step declares params and optimizer state
replicated, but each of its mesh devices keeps its own peer's copy in its
buffer and reads it in the next step; the port keeps those copies as an
explicit :class:`~repro_torch.core.p2p.PeerBank`. Row r of the port's bank
is held to mesh device r's buffer of the reference's params and optimizer
state (``addressable_shards``, each mapped by its device to its place in
the mesh), and the carried state that the reference all-gathers (the step
count, the async mailbox, the EF residual bank) is the same on every
device and equal to the port's.

Squeezenet1.1 on MNIST-shaped 8x8 data, 4 peers x batch 8, SGD with
momentum from a non-zero momentum state (Adam from its zero state at its
usual rate 1e-3 in one case: at SGD's 0.05 every Adam step moves every
coordinate by about 0.05 and the loss reaches 2.6e5), 3 steps: K + 1 for
the async case with K = 2, so a non-zero stale bank is read. The
reference runs once, in a subprocess with four host devices, and keeps
every device's state after each step. Each step of the port starts from
the reference's state before it (step 1 from the same init), so every step
is held on its own and no gap carries into the next.

Why: a ReLU input can lie within the two frameworks' rounding noise of 0
(one lay 2.07e-7 from it in fires/6/e1 of the ring case, step 3), and the
two sides then take opposite branches; over a free-running trajectory the
gap moves every later step onto other such boundaries. So the subprocess
also takes both sides' gradients of each peer at the reference's params
before each step, and the step's bound grows with their largest gap ``g``
(about 1e-6; 1e-3 to 1e-2 at a flipped ReLU) and the most one codec flip
can move a decoded element (``f``: a QSGD rounding, ``norm / s``, or a
top-k selection at a near tie, the k-th magnitude; ``tests/test_torch_p2p.py``):
each peer's mix is a convex combination of gradients, so momentum and the
EF residual move by at most ``g + f``, params by ``lr (g + f)`` (Adam's
update divides the gradient by ``sqrt(v) + eps``, so ``lr g / eps`` where
a gradient is below eps), the mailbox by ``g``, all plus 1e-5; and where
``g <= 1e-5`` and no codec runs, at most 1e-4 of the coordinates lie
beyond 1e-5. The sign_flip attacker publishes 10x its gradient, so its
gap counts 10x. Losses agree within rtol 1e-5.

Also here: the bank helpers, and the step's refusal of a single copy where
it keeps a bank and of a bank where it holds params once.
"""
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import convert, models
from repro_torch.core import compression as C
from repro_torch.core import p2p
from repro_torch.core.robust import AdversarySpec
from repro_torch.core.simulate import cnn_loss
from repro_torch.kernels import topk as K
from repro_torch.optim import adam, sgd
from test_torch_p2p import LR, PEERS, SRC, STEPS, _model, _replay_step_uniforms, _stacked_to_jax

torch.set_num_threads(2)  # the test workers share the CPU with each other

ADV = dict(num=1, attack="sign_flip", scale=10.0, seed=1)  # AdversarySpec fields
ADAM_LR, ADAM_EPS = 1e-3, 1e-8
CASES = {
    "ring": dict(graph="ring"),
    "hierarchical": dict(graph="hierarchical:2"),
    "ring_qsgd_ef": dict(graph="ring", exchange="qsgd", qsgd=(7, 256), ef=True),
    "ring_topk_ef": dict(graph="ring", exchange="topk", topk_frac=0.05, ef=True),
    "async_k1": dict(exchange="async", staleness=1),
    "ring_async_k2": dict(graph="ring", exchange="async", staleness=2),
    # 0.34 of a ring peer's three members trims one from each end; 0.25
    # trims none, and the attacker's 10x row then drives both sides' params
    # to 1e25
    "ring_trimmed_sign_flip": dict(graph="ring", exchange="trimmed_mean:0.34", adversary=ADV),
    "ring_median": dict(graph="ring", exchange="median"),
    "ring_adam": dict(graph="ring", optimizer="adam"),
}

REFERENCE = textwrap.dedent(
    """
    import dataclasses, os, sys
    import jax, jax.numpy as jnp, numpy as np
    import torch
    from repro import compat
    from repro.configs import get_config
    from repro.core.compression import QSGDConfig
    from repro.core.p2p import Topology, TrainState, build_p2p_train_step, init_ef, init_mailbox
    from repro.core.robust import AdversarySpec
    from repro.core.simulate import cnn_loss
    from repro.data import BatchKey, DataLoader, Partitioner, make_dataset
    from repro.models import init_model
    from repro.optim import adam, sgd
    from repro.train.checkpoint import _flatten
    from repro_torch import convert as tconvert, models as tmodels
    from repro_torch.configs import get_config as tget_config
    from repro_torch.core.simulate import cnn_loss as tcnn_loss

    torch.set_num_threads(2)
    out_dir, peers, lr, steps, cases = sys.argv[1], 4, 0.05, 3, eval(sys.argv[2])
    ds = make_dataset("mnist", size=128, image_hw=8, channels=1)
    cfg = dataclasses.replace(get_config("squeezenet1.1"), image_size=8,
                              image_channels=1, num_classes=ds.num_classes)
    params = init_model(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    mom = jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32) * 1e-3), params)
    loader = DataLoader(Partitioner(ds, 1, shuffle_seed=0), 0, peers * 8)
    batches = [loader.load(BatchKey(0, 0, i)) for i in range(steps)]
    common = {f"init/{k}": v for k, v in _flatten(params).items()}
    common.update({f"mom0/{k}": v for k, v in _flatten(mom).items()})
    for i, b in enumerate(batches):
        common[f"batch{i}/images"], common[f"batch{i}/labels"] = b["images"], b["labels"]
    np.savez(os.path.join(out_dir, "common.npz"), **common)

    mesh = compat.make_mesh((peers,), ("data",), axis_types=(compat.AxisType.Auto,))
    place = {d: i for i, d in enumerate(mesh.devices.flat)}

    def rows(x):
        # every mesh device's own buffer of a leaf, stacked in mesh order;
        # before the first step a leaf is one copy, not yet on the mesh
        if len(x.addressable_shards) == 1:
            return np.stack([np.asarray(x)] * peers)
        got = {place[s.device]: np.asarray(s.data) for s in x.addressable_shards}
        return np.stack([got[i] for i in range(peers)])

    def one_copy(tree, what):
        # the all-gathered carry: every device's buffer the same
        flat = _flatten(jax.tree.map(rows, tree))
        for k, v in flat.items():
            if not all(np.array_equal(v[r], v[0]) for r in range(peers)):
                raise SystemExit(f"{what} {k} differs between devices")
        return {k: v[0] for k, v in flat.items()}

    # each peer's gradient at its device's params, the reference's and the port's
    loss_fn = lambda p, b: cnn_loss(p, b, cfg)
    tmodel = tmodels.init_model(dataclasses.replace(
        tget_config("squeezenet1.1"), image_size=8, image_channels=1, num_classes=ds.num_classes),
        generator=torch.Generator().manual_seed(0), device="cpu").requires_grad_(False)
    tgrad = torch.func.grad(lambda p, b: tcnn_loss(tmodel, p, *b), has_aux=True)
    jgrad = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))

    def gradient_gap(params, b):
        stacked, gap = jax.tree.map(rows, params), 0.0
        for r in range(peers):
            p = jax.tree.map(lambda x: x[r], stacked)
            part = {k: v[r * 8:(r + 1) * 8] for k, v in b.items()}
            theirs = _flatten(jgrad(p, jax.tree.map(jnp.asarray, part)))
            ours = tconvert.to_jax(tgrad(tconvert.from_jax(_flatten(p), device="cpu"), (
                tmodels.images_to_device(part["images"], "cpu"),
                torch.from_numpy(part["labels"].astype(np.int64))))[0])
            gap = max(gap, max(float(np.abs(ours[k] - theirs[k]).max()) for k in theirs))
        return gap

    for name, kw in cases.items():
        kw = dict(kw)
        if "qsgd" in kw:
            kw["qsgd"] = QSGDConfig(*kw["qsgd"])
        adv = kw.pop("adversary", None)
        opt, rate = ((adam(), 1e-3) if kw.pop("optimizer", "sgd") == "adam"
                     else (sgd(momentum=0.9), lr))
        topo = Topology(peer_axes=("data",), lambda_axis=None, **kw)
        step = jax.jit(build_p2p_train_step(
            loss_fn, opt, topo, mesh, lambda s: rate,
            adversary=None if adv is None else AdversarySpec(**adv)))
        st = TrainState(params=params, opt_state=opt.init(params) if "mu" in opt.init(params)
                        else mom, step=jnp.zeros((), jnp.int32), key=jax.random.PRNGKey(0))
        if topo.ef:
            st = st.replace(ef=init_ef(params, peers))
        if topo.exchange == "async":
            st = st.replace(mailbox=init_mailbox(params, peers, staleness=topo.staleness))
        out, losses, gaps = {}, [], []
        with compat.set_mesh(mesh):
            for s, b in enumerate(batches):
                gaps.append(gradient_gap(st.params, b))
                st, m = step(st, jax.tree.map(jnp.asarray, b))
                losses.append(float(m["loss"]))
                jax.block_until_ready(st)
                out.update({f"{s}/params/{k}": v for k, v in _flatten(jax.tree.map(rows, st.params)).items()})
                out.update({f"{s}/opt_state/{k}": v
                            for k, v in _flatten(jax.tree.map(rows, st.opt_state)).items()})
                for what in ("ef", "mailbox"):
                    if getattr(st, what) is not None:
                        out.update({f"{s}/{what}/{k}": v
                                    for k, v in one_copy(getattr(st, what), what).items()})
                out[f"{s}/step"] = one_copy({"s": st.step}, "step")["s"]
        out["grad_gap"], out["loss"] = np.asarray(gaps), np.asarray(losses)
        np.savez(os.path.join(out_dir, f"{name}.npz"), **out)
    print("OK")
    """
)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``reference(case)`` -> the case's npz (``common`` for the init, the
    momentum and the batches); about 0.8 GB of snapshots, removed after the
    module's tests."""
    out = tmp_path_factory.mktemp("p2p_sparse")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(out), repr(CASES)], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    yield lambda case: np.load(out / f"{case}.npz")
    shutil.rmtree(out, ignore_errors=True)


def _part(npz, prefix):
    return {k[len(prefix) + 1:]: npz[k] for k in npz if k.startswith(prefix + "/")}


def _bank(flat, lead):
    """Reference ``{path: (lead..., *shape)}`` -> port ``{name: tensor}``."""
    return {convert.torch_name(k): convert.to_torch_layout(torch.from_numpy(np.array(v)), lead=lead)
            for k, v in flat.items()}


def _state_from_reference(snap, adam_opt):
    """The port's state from a reference snapshot: every device's params
    and moments as bank rows, the all-gathered carry as it is."""
    params = p2p.PeerBank(_bank(_part(snap, "params"), 1))
    opt = _part(snap, "opt_state")
    if adam_opt:
        opt_state = {m: p2p.PeerBank(_bank({k[len(m) + 1:]: v for k, v in opt.items()
                                            if k.startswith(m + "/")}, 1)) for m in ("mu", "nu")}
        opt_state["t"] = torch.tensor(int(opt["t"][0]), dtype=torch.int32)
    else:
        opt_state = p2p.PeerBank(_bank(opt, 1))
    ef, mailbox = _part(snap, "ef"), _part(snap, "mailbox")
    return params, opt_state, (_bank(ef, 1) if ef else None), (_bank(mailbox, 2) if mailbox else None)


def _gaps(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    return np.concatenate([np.abs(np.asarray(ours[k], np.float64) - theirs[k]).reshape(-1)
                           for k in theirs])


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_bank_row_matches_its_reference_device(reference, monkeypatch, case):
    kw = dict(CASES[case])
    adversary = kw.pop("adversary", None)
    is_adam = kw.pop("optimizer", "sgd") == "adam"
    opt, lr = (adam(eps=ADAM_EPS), ADAM_LR) if is_adam else (sgd(momentum=0.9), LR)
    if "qsgd" in kw:
        kw["qsgd"] = C.QSGDConfig(*kw["qsgd"])
    topo = p2p.Topology(**kw)
    model = _model()
    step = p2p.build_p2p_train_step(
        lambda p, b: cnn_loss(model, p, b["images"], b["labels"]), opt, topo, PEERS,
        lambda s: lr, adversary=None if adversary is None else AdversarySpec(**adversary),
        device="cpu")
    common, ref = reference("common"), reference(case)
    one = convert.from_jax(_part(common, "init"), device="cpu")
    flips = [0.0]  # the most one codec flip can move a decoded element
    if topo.exchange == "qsgd":
        _replay_step_uniforms(monkeypatch, len(one))
        reduce = C.dequant_reduce
        monkeypatch.setattr(C, "dequant_reduce", lambda lev, nrm, *a: (
            flips.append(float(nrm.max()) / topo.qsgd.levels), reduce(lev, nrm, *a))[1])
    if topo.exchange == "topk":
        select = K.topk_select_pack
        monkeypatch.setattr(K, "topk_select_pack", lambda x, k: (
            lambda v, i: (flips.append(float(v.abs().min())), (v, i))[1])(*select(x, k)))
    scale = 10.0 if adversary else 1.0  # the attacker publishes 10x its gradient's gap
    for s in range(STEPS):
        if s == 0:
            opt_state = opt.init(one) if is_adam else convert.opt_state_from_jax(
                _part(common, "mom0"), device="cpu")
            params, opt_state = p2p.peer_bank(one, opt_state, PEERS)
            ef = None if not topo.ef else p2p.init_ef(one, PEERS)
            mailbox = (p2p.init_mailbox(one, PEERS, staleness=topo.staleness)
                       if topo.exchange == "async" else None)
        else:
            params, opt_state, ef, mailbox = _state_from_reference(
                _part(ref, str(s - 1)), is_adam)
        state = p2p.TrainState(params, opt_state, s, torch.Generator().manual_seed(0),
                               mailbox=mailbox, ef=ef)
        raw = _part(common, f"batch{s}")
        flips[:] = [0.0]
        state, metrics = step(state, {"images": models.images_to_device(raw["images"], "cpu"),
                                      "labels": torch.from_numpy(raw["labels"].astype(np.int64))})
        assert metrics["grad_norm"].shape == metrics["aux"].shape == (PEERS,)
        np.testing.assert_allclose(float(metrics["loss"]), ref["loss"][s], rtol=1e-5)
        assert state.step == s + 1 == int(ref[f"{s}/step"])
        assert isinstance(state.params, p2p.PeerBank) and state.params.num_peers == PEERS

        g, f = scale * float(ref["grad_gap"][s]), max(flips)
        moved = g + f  # the most a peer's mix moved
        snap = _part(ref, str(s))
        theirs_p, theirs_o = _part(snap, "params"), _part(snap, "opt_state")
        pairs = []
        for r in range(PEERS):
            pairs.append((convert.to_jax(p2p.peer_row(state.params, r)),
                          {k: v[r] for k, v in theirs_p.items()},
                          lr * g / ADAM_EPS if is_adam else lr * moved))
            pairs.append((convert.opt_state_to_jax(p2p.peer_row(state.opt_state, r)),
                          {k: v[r] for k, v in theirs_o.items()}, moved))
        if topo.ef:
            pairs.append((_stacked_to_jax(state.ef), _part(snap, "ef"), moved))
        else:
            assert state.ef is None and not _part(snap, "ef")
        if topo.exchange == "async":
            pairs.append(({convert.jax_path(k): convert.to_jax_layout(v, lead=2).numpy()
                           for k, v in state.mailbox.items()}, _part(snap, "mailbox"), g))
        for ours, theirs, bound in pairs:
            gaps = _gaps(ours, theirs)
            assert gaps.max() <= bound + 1e-5, (case, s, gaps.max(), bound)
            if g <= 1e-5 and not f:  # a flipped ReLU moves the whole backward below it
                assert (gaps > 1e-5).sum() <= 1e-4 * gaps.size, (case, s, (gaps > 1e-5).sum())
    # the peers' trajectories differ: rows of the bank are not one copy
    rows = [convert.to_jax(p2p.peer_row(state.params, r)) for r in range(PEERS)]
    assert max(np.abs(rows[r][k] - rows[0][k]).max() for r in range(1, PEERS) for k in rows[0]) > 0


def test_bank_helpers_round_trip_and_keep_adams_step_count():
    """``peer_bank`` makes P copies (not views) of each params-shaped dict,
    leaves Adam's ``t`` one scalar; ``peer_row`` reads a row back; a bank
    carried through ``convert`` with ``lead=1`` comes back unchanged."""
    model = _model()
    one = {k: v.clone() for k, v in model.named_parameters()}
    state = adam().init(one)
    state["t"] = torch.tensor(3, dtype=torch.int32)
    bank, obank = p2p.peer_bank(one, state, PEERS)
    assert isinstance(bank, p2p.PeerBank) and bank.num_peers == PEERS
    assert isinstance(obank["mu"], p2p.PeerBank) and isinstance(obank["nu"], p2p.PeerBank)
    assert obank["t"] is state["t"]
    for r in range(PEERS):
        row = p2p.peer_row(bank, r)
        assert all(torch.equal(row[k], one[k]) for k in one)
        assert p2p.peer_row(obank, r)["t"] is state["t"]
    bank["stem.w"][1] += 1.0
    assert torch.equal(bank["stem.w"][0], one["stem.w"])  # copies, not views
    for k, v in bank.items():
        back = convert.to_torch_layout(convert.to_jax_layout(v, lead=1), lead=1)
        assert torch.equal(back, v), k
    momentum, = p2p.peer_bank(one, {}, PEERS)[1:]
    assert momentum == {}  # plain SGD has no state to bank
    with pytest.raises(ValueError, match="already a PeerBank"):
        p2p.peer_bank(bank, {}, PEERS)


def _tiny_step(topo, peers=PEERS):
    loss_fn = lambda p, b: (((b["x"] @ p["w"].T) ** 2).mean(), b["x"].sum())
    return p2p.build_p2p_train_step(loss_fn, sgd(momentum=0.9), topo, peers, lambda s: 0.1,
                                    device="cpu")


@pytest.mark.parametrize("topo", [p2p.Topology(graph="ring"), p2p.Topology(exchange="async")])
def test_a_per_peer_step_refuses_a_single_copy(topo):
    """Where the step keeps a bank, a single copy raises (a leaf whose first
    dimension is P would otherwise be taken for a bank), and so does a bank
    of another peer count or a momentum held once beside banked params."""
    w = torch.randn(PEERS, 3, generator=torch.Generator().manual_seed(0))  # first dim == P
    step = _tiny_step(topo)
    x = {"x": torch.randn(PEERS * 2, 3)}
    mailbox = p2p.init_mailbox({"w": w}, PEERS)
    with pytest.raises(ValueError, match="peer_bank"):
        step(p2p.TrainState({"w": w}, {"w": torch.zeros_like(w)}, 0, None, mailbox=mailbox), x)
    bank, mom = p2p.peer_bank({"w": w}, {"w": torch.zeros_like(w)}, PEERS)
    with pytest.raises(ValueError, match="peer_bank"):
        step(p2p.TrainState(bank, {"w": torch.zeros_like(w)}, 0, None, mailbox=mailbox), x)
    small, small_mom = p2p.peer_bank({"w": w}, {"w": torch.zeros_like(w)}, PEERS - 1)
    with pytest.raises(ValueError, match="3 rows for a 4-peer step"):
        step(p2p.TrainState(small, small_mom, 0, None, mailbox=mailbox), x)
    st, _ = step(p2p.TrainState(bank, mom, 0, None, mailbox=mailbox), x)
    assert isinstance(st.params, p2p.PeerBank) and isinstance(st.opt_state, p2p.PeerBank)
    assert st.params["w"].shape == (PEERS, PEERS, 3)


def test_the_full_graph_step_refuses_a_bank():
    w = torch.randn(2, 3, generator=torch.Generator().manual_seed(0))
    bank, mom = p2p.peer_bank({"w": w}, {"w": torch.zeros_like(w)}, PEERS)
    with pytest.raises(ValueError, match="got a PeerBank"):
        _tiny_step(p2p.Topology())(p2p.TrainState(bank, mom, 0, None), {"x": torch.randn(8, 3)})
