"""The port's LM training steps (``repro_torch.train``) against the
reference's ``repro/train/steps.py``, on the CPU.

``lm_loss`` and its gradients: reduced gemma2-2b (local and global layers
over a window of 64, both softcaps, tied embeddings), qwen2.5-3b (QKV
bias), starcoder2-3b and mamba2-370m (through ``ssd_chunked``, the
reference's default ``use_ssd_kernel=False``), in f32, weights a seeded
numpy fill of every reference leaf carried across by
``convert.lm_from_jax``. The loss and cross-entropy agree within rtol
1e-5, each gradient leaf within 1e-4 of its largest magnitude (XLA and
PyTorch sum the products in other orders; the attention's gradient comes
from the flash Function's plain backward on the port's side and from
``jax.grad`` of ``attend`` on the reference's).

``build_train_step``: two steps of reduced qwen2.5-3b, 2 peers x batch 2,
``allgather_mean``, Adam at 3e-3 under ``warmup_cosine``, against the
reference's step on a 2-device host mesh, run once in a subprocess as
``tests/test_torch_p2p.py`` runs it. The port starts from the reference's
``init_train_state`` output (params and Adam moments through ``convert``).
Adam divides by sqrt(nu) + 1e-8, so a coordinate whose gradient is near
1e-8 moves by up to lr on one side and less on the other (the key bias's
exact gradient is 0: a shift of every key's score by q . bk leaves the
softmax as it is, and both sides step on rounding noise there): params
agree within 2e-6 except on at most 1e-3 of the coordinates, which stay
within lr per step; the moments, whose second step's gradient is taken at
those params, within 5e-4 of their leaf's largest magnitude.
"""
import dataclasses
import functools
import inspect
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models.transformer import _unembed as junembed
from repro.train.checkpoint import _flatten
from repro.train.steps import lm_loss as jlm_loss
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core.p2p import Topology, TrainState, build_p2p_train_step
from repro_torch.optim import adam, warmup_cosine
from repro_torch.train import build_train_step, init_train_state, lm_loss, steps
from repro_torch.models.transformer import LM

torch.set_num_threads(2)  # the test workers share the CPU with each other

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ARCHS = {  # arch -> (reduced() overrides, sequence length)
    "gemma2-2b": (dict(num_layers=3), 80),
    "qwen2.5-3b": (dict(num_layers=2), 24),
    "starcoder2-3b": (dict(num_layers=2), 24),
    "mamba2-370m": (dict(num_layers=2), 40),
}
B = 2


def _cfgs(arch):
    kw = dict(ARCHS[arch][0], dtype="float32")
    return jreduced(jget_config(arch), **kw), reduced(get_config(arch), **kw)


def fill_params(jcfg, seed=0):
    """A seeded numpy fill of every reference leaf (the subprocess below
    runs this function's source too)."""
    import jax, jax.numpy as jnp, numpy as np  # noqa: E401 (the subprocess needs them here)
    from repro import models as jmodels
    linear = ("in_proj", "out_proj", "unembed", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
              "router")  # a MoE expert bank (E, din, dout) too
    shapes = jax.eval_shape(lambda: jmodels.init_model(jax.random.PRNGKey(0), jcfg))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    rng = np.random.default_rng(seed)
    arrays = []
    for path, sds in leaves:
        name = str(getattr(path[-1], "key", path[-1]))
        n = rng.normal(size=sds.shape)
        if name in linear:
            a = n / np.sqrt(sds.shape[-2])
        elif name == "embed":
            a = n * 0.5
        elif name == "A_log":
            a = np.log(np.linspace(1.0, 16.0, sds.shape[-1])) + 0.1 * n
        elif name in ("scale", "D"):
            a = 1.0 + 0.1 * n
        else:  # conv_w, conv_b, dt_bias, the attention biases
            a = 0.1 * n
        arrays.append(jnp.asarray(a, jnp.float32))
    return jax.tree_util.tree_unflatten(treedef, arrays)


def _batch(cfg, n, rows=B, seed=1):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(rows, n + 1))
    return tokens[:, :-1].astype(np.int32), tokens[:, 1:].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_value_and_grad(jcfg):
    return jax.jit(jax.value_and_grad(lambda p, b: jlm_loss(p, b, jcfg), has_aux=True))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lm_loss_and_gradients_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jparams = fill_params(jcfg)
    tokens, labels = _batch(cfg, ARCHS[arch][1])
    (jloss, jce), jgrads = _reference_value_and_grad(jcfg)(
        jparams, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    params = convert.lm_from_jax(_flatten(jparams), cfg, device="cpu")
    with torch.device("meta"):
        model = LM(cfg, generator=None, device="meta")
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    grads, (loss, ce) = torch.func.grad_and_value(
        lambda p: lm_loss(model, p, batch, cfg), has_aux=True)(params)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-5)
    assert float(loss) > float(ce)  # the z-loss is positive
    want = convert.lm_from_jax(_flatten(jgrads), cfg, device="cpu")
    assert set(grads) == set(want) == set(params)
    for name, g in grads.items():
        scale = float(want[name].abs().max())
        err = float((g - want[name]).abs().max())
        assert err <= 1e-4 * scale + 1e-9, f"{arch} {name}: {err:.3e} beyond 1e-4 x {scale:.3e}"


def test_moe_config_raises():
    """A MoE config's loss refuses an unknown dispatch with the reference's
    ``ValueError`` (MoE is ported: the dense and capacity dispatches run)."""
    cfg = reduced(get_config("granite-moe-3b-a800m"), num_layers=1)
    jcfg = jreduced(jget_config("granite-moe-3b-a800m"), num_layers=1)
    tokens, labels = _batch(cfg, 8)
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    params = init_train_state(torch.Generator().manual_seed(0), cfg, adam(), device="cpu").params
    with torch.device("meta"):
        model = LM(cfg, generator=None, device="meta")
    with pytest.raises(ValueError, match="unknown moe dispatch 'sorted'"):
        lm_loss(model, params, batch, cfg, moe_dispatch="sorted")
    with pytest.raises(ValueError, match="unknown moe dispatch 'sorted'"):
        jlm_loss(fill_params(jcfg), {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
                 jcfg, moe_dispatch="sorted")


def test_init_train_state_matches_the_model_and_optimizer():
    cfg = reduced(get_config("qwen2.5-3b"))
    state = init_train_state(torch.Generator().manual_seed(0), cfg, adam(), device="cpu")
    model = LM(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert set(state.params) == {k for k, _ in model.named_parameters()}
    for k, p in model.named_parameters():
        assert torch.equal(state.params[k], p.detach()) and not state.params[k].requires_grad
    assert state.step == 0 and int(state.opt_state["t"]) == 0
    assert all(float(m.abs().max()) == 0.0 for m in state.opt_state["mu"].values())


# ---------------------------------------------------------------------------
# two train steps against the reference's, on a 2-device host mesh
# ---------------------------------------------------------------------------

PEERS, STEPS, LR, SEQ = 2, 2, 3e-3, 16
SCHEDULE = (LR, 0, 4)  # warmup_cosine(lr, warmup, total): a non-zero rate on both steps

REFERENCE = inspect.getsource(fill_params) + textwrap.dedent(
    """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro.configs import get_config, reduced
    from repro.core.p2p import Topology
    from repro.optim import adam
    from repro.optim.schedules import warmup_cosine
    from repro.train.checkpoint import _flatten
    from repro.train.steps import build_train_step, init_train_state

    out_path, peers, seq, schedule = sys.argv[1], 2, 16, eval(sys.argv[2])
    arch, overrides, (steps, fill, fixed) = sys.argv[3], eval(sys.argv[4]), eval(sys.argv[5])
    cfg = reduced(get_config(arch), dtype="float32", **overrides)
    opt = adam()
    state = init_train_state(jax.random.PRNGKey(0), cfg, opt)
    if fill:  # the same fill as the CPU tests, else init_model's own weights
        state = state.replace(params=fill_params(cfg))
        state = state.replace(opt_state=opt.init(state.params))
    rng = np.random.default_rng(3)
    out = {f"init/params/{k}": v for k, v in _flatten(state.params).items()}
    out.update({f"init/opt/{k}": v for k, v in _flatten(state.opt_state).items()})
    mesh = compat.make_mesh((peers,), ("data",), axis_types=(compat.AxisType.Auto,))
    topo = Topology(peer_axes=("data",), lambda_axis=None, exchange="allgather_mean")
    step = jax.jit(build_train_step(cfg, opt, topo, mesh, warmup_cosine(*schedule)))
    losses = []
    with compat.set_mesh(mesh):
        for s in range(steps):
            if not (fixed and s):
                toks = rng.integers(0, cfg.vocab_size, size=(2 * peers, seq + 1)).astype(np.int32)
                extra = {}  # whisper's frames, the VLM's patches
                for key, n in (("frames", cfg.encoder_seq), ("patches", cfg.vision_tokens)):
                    if n:
                        extra[key] = rng.normal(size=(2 * peers, n, cfg.d_model)).astype(np.float32)
            out[f"batch{s}"] = toks
            out.update({f"{key}{s}": a for key, a in extra.items()})
            state, m = step(state, {"tokens": jnp.asarray(toks[:, :-1]),
                                    "labels": jnp.asarray(toks[:, 1:]),
                                    **{key: jnp.asarray(a) for key, a in extra.items()}})
            losses.append(float(m["loss"]))
            out.update({f"step{s}/params/{k}": v for k, v in _flatten(state.params).items()})
            out.update({f"step{s}/opt/{k}": v for k, v in _flatten(state.opt_state).items()})
    out.update({f"final/params/{k}": v for k, v in _flatten(state.params).items()})
    out.update({f"final/opt/{k}": v for k, v in _flatten(state.opt_state).items()})
    out["loss"] = np.asarray(losses)
    np.savez(out_path, **out)
    print("OK")
    """
)


def run_reference_steps(out_dir, arch="qwen2.5-3b", *, steps=STEPS, schedule=SCHEDULE, fill=True,
                        fixed=False, **overrides):
    """The reference's ``build_train_step`` on a 2-device host mesh, ``steps``
    steps under ``warmup_cosine(*schedule)`` of ``reduced(arch,
    dtype="float32", **overrides)`` from ``fill_params`` (``fill=False``:
    from ``init_train_state``'s own weights), each step on a new batch
    (``fixed``: all on the first; whisper's with normal frames, the VLM's
    with normal patches), in a subprocess. Returns a reader of
    what it saved: ``read(prefix)`` gives the ``{path: array}`` under
    ``prefix/`` or the array named ``prefix``."""
    path = out_dir / "reference.npz"
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={PEERS}",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path), repr(schedule), arch,
                        repr(overrides), repr((steps, fill, fixed))], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    with np.load(path) as npz:
        data = dict(npz)
    return lambda prefix: {k[len(prefix) + 1:]: v for k, v in data.items()
                           if k.startswith(prefix + "/")} or data[prefix]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference_steps(tmp_path_factory.mktemp("train"))


def hold_steps_to_reference(reference, cfg, *, settle=False, **step_kw):
    """STEPS port steps of ``build_train_step`` from the reference's initial
    state and batches, held to the reference's losses, params and Adam
    moments (the tolerances of the module docstring). With ``settle``,
    before each step after the first, the coordinates that the step before
    left beyond 2e-6 of the reference's take the reference's values
    (``_settle``); everything else runs on from the port's own state.
    Returns the final state."""
    opt = adam()
    state = TrainState(
        params=convert.lm_from_jax(reference("init/params"), cfg, device="cpu"),
        opt_state=convert.opt_state_from_jax(reference("init/opt"), device="cpu", cfg=cfg),
        step=0, key=None)
    step = build_train_step(cfg, opt, Topology(), PEERS, warmup_cosine(*SCHEDULE), device="cpu",
                            **step_kw)
    losses = []
    for s in range(STEPS):
        if settle and s:
            state = _settle(state, reference, s - 1, cfg)
        toks = torch.from_numpy(reference(f"batch{s}")).long()
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for key, n in (("frames", cfg.encoder_seq), ("patches", cfg.vision_tokens)):
            if n:
                batch[key] = torch.from_numpy(reference(f"{key}{s}"))
        state, metrics = step(state, batch)
        assert metrics["loss"].shape == () and metrics["aux"].shape == (PEERS,)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, reference("loss"), rtol=1e-5)
    assert state.step == STEPS and int(state.opt_state["t"]) == STEPS
    _hold_state(state, reference, "final", cfg)
    return state


def _settle(state, reference, s, cfg, b1=0.9):
    """Reference behaviour 25. Adam's first step moves a coordinate by
    lr g / (|g| + 1e-8): where |g| is within a few hundred times 1e-8, the
    last bits of g, which XLA and PyTorch round apart, decide the size of
    the move. After step ``s`` the port's state must lie within the
    tolerances of the module docstring, and each coordinate beyond 2e-6 of
    the reference's must be one whose gradient on the reference's side (its
    first moment's increment, mu_s - b1 mu_(s-1) = (1 - b1) g, b1 as in
    ``adam()``) lies within 2e-5 of its leaf's largest. Those coordinates
    take the reference's values; the rest of the state is the port's own."""
    _hold_state(state, reference, f"step{s}", cfg)
    want = convert.lm_from_jax(reference(f"step{s}/params"), cfg, device="cpu")
    moment = lambda prefix: convert.opt_state_from_jax(reference(f"{prefix}/opt"), device="cpu",
                                                       cfg=cfg)["mu"]
    mu, mu_before = moment(f"step{s}"), moment(f"step{s - 1}" if s else "init")
    params = dict(state.params)
    for k, w in want.items():
        far = (params[k] - w).abs() > 2e-6
        if far.any():
            g = mu[k] - b1 * mu_before[k]
            assert float(g[far].abs().max()) <= 2e-5 * float(g.abs().max()), k
            params[k] = torch.where(far, w, params[k])
    return dataclasses.replace(state, params=params)


def _hold_state(state, reference, prefix, cfg):
    want = convert.lm_from_jax(reference(f"{prefix}/params"), cfg, device="cpu")
    n_all = sum(p.numel() for p in want.values())
    n_far = sum(int(((state.params[k] - w).abs() > 2e-6).sum()) for k, w in want.items())
    worst = max(float((state.params[k] - w).abs().max()) for k, w in want.items())
    assert n_far <= 1e-3 * n_all, f"{n_far} of {n_all} params beyond 2e-6"
    assert worst <= LR * STEPS, f"params gap {worst:.3e}"
    moments = convert.opt_state_from_jax(reference(f"{prefix}/opt"), device="cpu", cfg=cfg)
    for which in ("mu", "nu"):
        for k, w in moments[which].items():
            err = float((state.opt_state[which][k] - w).abs().max())
            assert err <= 5e-4 * float(w.abs().max()) + 1e-12, f"{which} {k}: {err:.3e}"


def test_two_train_steps_match_reference(reference):
    hold_steps_to_reference(reference, reduced(get_config("qwen2.5-3b"), dtype="float32"))


def test_donated_step_writes_the_same_state_into_the_inputs_tensors():
    """``build_train_step`` donates its state (what the full-width LMs need
    to fit one card): the same params and moments bit for bit as the
    functional ``build_p2p_train_step`` over the same loss, written into
    the input state's own tensors."""
    cfg = reduced(get_config("gemma2-2b"), num_layers=2, dtype="float32")
    opt = adam()
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, size=(4, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with torch.device("meta"):
        model = LM(cfg, generator=None, device="meta")
    functional = build_p2p_train_step(lambda p, b: lm_loss(model, p, b, cfg), opt, Topology(),
                                      PEERS, warmup_cosine(*SCHEDULE), device="cpu")
    donating = build_train_step(cfg, opt, Topology(), PEERS, warmup_cosine(*SCHEDULE),
                                device="cpu")
    results = {}
    for donate, step in ((False, functional), (True, donating)):
        state = init_train_state(torch.Generator().manual_seed(0), cfg, opt, device="cpu")
        inputs = dict(state.params), dict(state.opt_state["mu"])
        new, _ = step(state, batch)
        new, _ = step(new, batch)
        same = [new.params[k] is inputs[0][k] and new.opt_state["mu"][k] is inputs[1][k]
                for k in inputs[0]]
        assert all(same) if donate else not any(same)
        results[donate] = new
    for k in results[False].params:
        assert torch.equal(results[True].params[k], results[False].params[k])
        for m in ("mu", "nu"):
            assert torch.equal(results[True].opt_state[m][k], results[False].opt_state[m][k])
    assert int(results[True].opt_state["t"]) == int(results[False].opt_state["t"]) == 2


# ---------------------------------------------------------------------------
# The loss's chunked LM head (``train.steps.ChunkedHeadFn``)
# ---------------------------------------------------------------------------

def _ragged_chunk(monkeypatch, vocab, rows=7):
    """A chunk of ``rows`` tokens' f32 logits: it divides none of the
    token counts below."""
    monkeypatch.setattr(steps, "LOGITS_CHUNK_BYTES", rows * 4 * vocab)
    assert steps._chunk_rows(vocab) == rows


@pytest.mark.parametrize("chunk", ["one", "ragged"])
def test_chunked_head_matches_the_reference_head(monkeypatch, chunk):
    """The head alone: lse and gold logit of every token from
    ``ChunkedHeadFn``, made into the reference's ce + z-loss, against
    ``jax.value_and_grad`` of the reference's ``_unembed`` (tied, the final
    softcap 30, vocab 500 padded to 512) and its loss, in the hidden state x
    and the embedding w: the loss within rtol 1e-5, dx and dw within 1e-4
    of their largest magnitude, in one chunk and in chunks of 7 tokens."""
    jcfg, cfg = (dataclasses.replace(c, vocab_size=500) for c in _cfgs("gemma2-2b"))
    assert cfg.padded_vocab == 512 and cfg.tie_embeddings and cfg.final_logit_softcap
    if chunk == "ragged":
        _ragged_chunk(monkeypatch, cfg.vocab_size)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 37, cfg.d_model)).astype(np.float32)
    w = (rng.standard_normal((cfg.padded_vocab, cfg.d_model)) * 0.5).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, size=(B, 37))

    def ref_loss(x, w):
        logits = junembed({"embed": w}, x, jcfg)
        lse = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, jnp.asarray(labels)[..., None], axis=-1)[..., 0]
        return (lse - gold).mean() + 1e-4 * jnp.square(lse).mean()

    jloss, (jdx, jdw) = jax.value_and_grad(ref_loss, argnums=(0, 1))(x, w)
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    lse, gold = steps.ChunkedHeadFn.apply(xt.reshape(-1, cfg.d_model), wt,
                                          torch.from_numpy(labels).reshape(-1), cfg.vocab_size,
                                          cfg.final_logit_softcap)
    loss = (lse - gold).mean() + 1e-4 * torch.square(lse).mean()
    dx, dw = torch.autograd.grad(loss, (xt, wt))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for name, got, want in (("dx", dx, jdx), ("dw", dw, jdw)):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), f"{name}: {err:.3e}"
    assert float(dw[cfg.vocab_size:].abs().max()) == 0.0  # the padded rows


def test_lm_loss_matches_reference_in_ragged_chunks(monkeypatch):
    """``lm_loss`` through reduced gemma2-2b (tied embeddings, both
    softcaps) with the head in chunks of 7 tokens (2 x 80 tokens): the
    reference's loss and ``jax.grad`` at ``test_lm_loss_and_gradients_match_reference``'s
    tolerances."""
    jcfg, cfg = _cfgs("gemma2-2b")
    _ragged_chunk(monkeypatch, cfg.vocab_size)
    jparams = fill_params(jcfg)
    tokens, labels = _batch(cfg, ARCHS["gemma2-2b"][1])
    (jloss, jce), jgrads = _reference_value_and_grad(jcfg)(
        jparams, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    params = convert.lm_from_jax(_flatten(jparams), cfg, device="cpu")
    with torch.device("meta"):
        model = LM(cfg, generator=None, device="meta")
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    grads, (loss, ce) = torch.func.grad_and_value(
        lambda p: lm_loss(model, p, batch, cfg), has_aux=True)(params)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-5)
    want = convert.lm_from_jax(_flatten(jgrads), cfg, device="cpu")
    for name, g in grads.items():
        scale = float(want[name].abs().max())
        err = float((g - want[name]).abs().max())
        assert err <= 1e-4 * scale + 1e-9, f"{name}: {err:.3e} beyond 1e-4 x {scale:.3e}"


def test_chunked_head_under_vmap_over_two_peers(monkeypatch):
    """Both transform orders of the P2P step over 2 peers with shared
    params, the head in chunks of 7 tokens: ``vmap(grad(lm_loss))`` (the
    per-peer bank) equals a loop over the peers, and ``grad`` of the
    peers' mean loss under ``vmap`` (the bank-free mean) equals the loop's
    mean, each within 1e-6 of the largest magnitude (the peers' tokens
    sum in another order)."""
    jcfg, cfg = _cfgs("gemma2-2b")
    _ragged_chunk(monkeypatch, cfg.vocab_size)
    params = convert.lm_from_jax(_flatten(fill_params(jcfg)), cfg, device="cpu")
    with torch.device("meta"):
        model = LM(cfg, generator=None, device="meta")
    tokens, labels = _batch(cfg, 40, rows=4)
    split = {"tokens": torch.from_numpy(tokens).long().reshape(2, 2, -1),
             "labels": torch.from_numpy(labels).long().reshape(2, 2, -1)}
    loss = lambda p, b: lm_loss(model, p, b, cfg)[0]
    loop = [torch.func.grad(loss)(params, {k: v[i] for k, v in split.items()}) for i in range(2)]
    bank = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(params, split)
    mean = torch.func.grad(lambda p: torch.func.vmap(loss, in_dims=(None, 0))(p, split).mean())(
        params)
    for name in params:
        want = torch.stack([g[name] for g in loop])
        scale = float(want.abs().max())
        assert float((bank[name] - want).abs().max()) <= 1e-6 * scale, name
        assert float((mean[name] - want.mean(dim=0)).abs().max()) <= 1e-6 * scale, name
