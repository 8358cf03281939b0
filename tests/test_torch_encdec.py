"""The port's encoder-decoder (whisper-base) against the reference's, on the CPU.

The model is ``reduced(whisper-base)``: 2 encoder and 2 decoder layers,
d_model 128, 4 heads of 32 over 2 KV heads, encoder_seq 64, vocabulary
512; the frames (B, 64, d) are seeded normals, standing in for the stubbed
conv frontend's output as in the reference. Weights: a seeded numpy fill of
every reference leaf (``test_torch_train_steps.fill_params``), carried
across by ``convert.lm_from_jax``.

Tolerances as in ``tests/test_torch_lm.py``: in f32 the logits within
atol 1e-4 and rtol 1e-4, the encoder's output, caches and cross K/V within
1e-5, greedy tokens identical; in the config's bf16 the forward and prefill
logits within twice the reference's own bf16 error (its bf16 logits against
its f32 logits). The sinusoidal table and the cross-attention layer within
1e-6 in f32. The loss within rtol 1e-5 and each gradient leaf within 1e-4
of its largest magnitude, with remat on and off; two ``build_train_step``
steps against the reference's 2-device step
(``test_torch_train_steps``' harness and tolerances).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train import checkpoint as jck
from repro.train.checkpoint import _flatten
from repro.train.steps import lm_loss as jlm_loss
from repro_torch import convert, models
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ck
from repro_torch.train import lm_loss
from test_torch_train_steps import fill_params, hold_steps_to_reference, run_reference_steps

torch.set_num_threads(2)  # the test workers share the CPU with each other

ARCH = "whisper-base"
B, S, GEN = 2, 24, 4


def _cfgs(dtype="float32", **kw):
    kw = dict(dict(dtype=dtype), **kw)
    return jreduced(jget_config(ARCH), **kw), reduced(get_config(ARCH), **kw)


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32"):
    jcfg, cfg = _cfgs(dtype)
    jparams = fill_params(jcfg)
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(convert.lm_from_jax(_flatten(jparams), cfg, device="cpu"))
    return jcfg, cfg, jparams, model.requires_grad_(False)


def _inputs(cfg, seed=1, rows=B, n=S):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(rows, n + 1)).astype(np.int32)
    frames = rng.normal(size=(rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return tokens[:, :-1], tokens[:, 1:], frames


def test_layout_matches_the_reference():
    """The reference's ``init_encdec`` at full size (109,854,720 params) and
    reduced: the same param count, and every reduced leaf's shape."""
    for jcfg, cfg in ((jget_config(ARCH), get_config(ARCH)),
                      (jreduced(jget_config(ARCH)), reduced(get_config(ARCH)))):
        shapes = jax.eval_shape(lambda: jmodels.init_model(jax.random.PRNGKey(0), jcfg))
        model = models.init_model(cfg, generator=None, device="meta")
        assert models.param_count(model) == sum(x.size for x in jax.tree.leaves(shapes))
    assert models.param_count(models.init_model(get_config(ARCH), generator=None,
                                                device="meta")) == 109_854_720
    zeros = _flatten(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes))
    ported = convert.lm_from_jax(zeros, cfg, device="cpu")
    assert {k: tuple(t.shape) for k, t in ported.items()} == {
        k: tuple(p.shape) for k, p in model.named_parameters()}
    assert len(model.encoder) == 2 and len(model.decoder) == 2
    assert "decoder.0.cross.wq.weight" in ported and "decoder.1.ln_cross.scale" in ported
    assert not any("cross" in n for n in ported if n.startswith("encoder."))


def test_sinusoidal_matches_reference():
    rng = np.random.default_rng(0)
    for positions in (np.arange(1500), rng.integers(0, 448, size=37)):
        for d in (2, 128, 512):
            ours = T._sinusoidal(torch.from_numpy(positions), d)
            theirs = np.asarray(JT._sinusoidal(jnp.asarray(positions), d))
            assert ours.dtype == torch.float32 and ours.shape == theirs.shape
            np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-6 * max(1, positions.max()),
                                       rtol=0)


def test_cross_attention_matches_reference():
    """The cross branch of ``attention_apply`` on the same q input and
    encoder K/V: the full-sequence route (the flash wrapper, non-causal)
    and a decoding step (``attend`` over arange(Senc))."""
    jcfg, cfg, jparams, model = _pair()
    attn = model.decoder[0].cross
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    kv = [rng.normal(size=(B, cfg.encoder_seq, cfg.num_kv_heads, cfg.resolved_head_dim))
          .astype(np.float32) for _ in range(2)]
    p = jax.tree.map(lambda a: a[0], jparams["decoder"])["cross"]
    for rows, cache_pos in ((slice(None), None), (slice(5, 6), 5)):
        pos = np.arange(S)[rows]
        theirs, _ = JL.attention_apply(p, jnp.asarray(x[:, rows]), jcfg,
                                       positions=jnp.asarray(pos),
                                       cross_kv=tuple(jnp.asarray(a) for a in kv))
        with torch.no_grad():
            ours, cache = L.attention_apply(attn, torch.from_numpy(x[:, rows]), cfg,
                                            positions=torch.from_numpy(pos), cache_pos=cache_pos,
                                            cross_kv=tuple(torch.from_numpy(a) for a in kv))
        assert cache is None
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6, rtol=1e-5)


def test_cross_and_encoder_attention_go_through_the_flash_wrapper(monkeypatch):
    """The forward and prefill call the flash wrapper once per encoder layer
    (non-causal), decoder self-attention (causal) and cross attention
    (non-causal, Sq = S against Skv = encoder_seq); decode does not."""
    _, cfg, _, model = _pair()
    calls = []

    def counting(q, k, v, **kw):
        calls.append((kw["causal"], q.shape[1], k.shape[1]))
        return flash(q, k, v, **kw)

    flash = L.flash_attention
    monkeypatch.setattr(L, "flash_attention", counting)
    tokens, _, frames = _inputs(cfg, seed=6)
    E = cfg.encoder_seq
    want = [(False, E, E)] * 2 + [(True, S, S), (False, S, E)] * 2
    with torch.no_grad():
        models.forward(model, {"tokens": tokens, "frames": frames}, cfg)
        assert calls == want
        state = models.init_decode_state(cfg, B, S + 2, device="cpu")
        logits, state = models.prefill(model, state, {"tokens": tokens, "frames": frames}, cfg)
        assert calls == want * 2
        models.decode_step(model, state, logits.argmax(-1)[:, None], cfg)
    assert calls == want * 2


@functools.lru_cache(maxsize=None)
def _jit_forward(jcfg):
    return jax.jit(lambda p, t, f: jmodels.forward(p, {"tokens": t, "frames": f}, jcfg)[0])


def test_encode_and_forward_match_reference_f32():
    jcfg, cfg, jparams, model = _pair()
    tokens, _, frames = _inputs(cfg)
    enc = np.asarray(jax.jit(lambda p, f: JT.encode(p, f, jcfg))(jparams, jnp.asarray(frames)))
    ref = np.asarray(_jit_forward(jcfg)(jparams, jnp.asarray(tokens), jnp.asarray(frames)))
    with torch.no_grad():
        ours_enc = T.encode(model, torch.from_numpy(frames), cfg)
        logits, aux = models.forward(model, {"tokens": tokens, "frames": frames}, cfg)
    np.testing.assert_allclose(ours_enc.numpy(), enc, atol=1e-5, rtol=1e-5)
    assert logits.shape == (B, S, cfg.vocab_size) and logits.dtype == torch.float32
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_cross_attention_matters():
    """The reference's ``tests/test_models.py`` behaviour, in the port: other
    frames give other logits for the same tokens."""
    _, cfg, _, model = _pair()
    tokens, _, f1 = _inputs(cfg, seed=7)
    _, _, f2 = _inputs(cfg, seed=8)
    with torch.no_grad():
        l1, _ = models.forward(model, {"tokens": tokens, "frames": f1}, cfg)
        l2, _ = models.forward(model, {"tokens": tokens, "frames": f2}, cfg)
    assert float((l1 - l2).abs().max()) > 1e-3


def _reference_serve(jcfg, jparams, tokens, frames):
    state = jmodels.init_decode_state(jcfg, B, tokens.shape[1] + GEN)
    logits, state = jax.jit(lambda p, s, t, f: jmodels.prefill(p, s, {"tokens": t, "frames": f},
                                                               jcfg))(
        jparams, state, jnp.asarray(tokens), jnp.asarray(frames))
    step = jax.jit(lambda p, s, t: jmodels.decode_step(p, s, t, jcfg))
    first = (np.asarray(logits), jax.tree.map(np.asarray, state))
    toks, steps = [], []
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for _ in range(GEN):
        toks.append(np.asarray(tok)[:, 0])
        logits, state = step(jparams, state, tok)
        steps.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    return first, np.stack(toks, 1), steps


def test_prefill_and_greedy_decode_match_reference_f32():
    """Prefill encodes once, writes each decoder layer's cross K/V and KV
    cache (in place), its last logits equal to the forward's last row;
    then 4 greedy decode steps over both caches."""
    jcfg, cfg, jparams, model = _pair()
    tokens, _, frames = _inputs(cfg, seed=2)
    (jlogits, jstate), jtoks, jsteps = _reference_serve(jcfg, jparams, tokens, frames)
    with torch.no_grad():
        full, _ = models.forward(model, {"tokens": tokens, "frames": frames}, cfg)
        state = models.init_decode_state(cfg, B, S + GEN, device="cpu")
        buffers = state["cross"]["k"], state["self"][0]["k"]
        logits, state = models.prefill(model, state, {"tokens": tokens, "frames": frames}, cfg)
        assert state["cross"]["k"] is buffers[0] and state["self"][0]["k"] is buffers[1]
        np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), atol=1e-4, rtol=1e-4)
        assert state["pos"] == int(jstate["pos"]) == S
        for k in ("k", "v"):
            assert state["cross"][k].shape == jstate["cross"][k].shape
            np.testing.assert_allclose(state["cross"][k].numpy(), jstate["cross"][k], atol=1e-5,
                                       rtol=1e-5)
            for layer, cache in enumerate(state["self"]):
                np.testing.assert_allclose(cache[k].numpy(), jstate["self"][k][layer], atol=1e-5,
                                           rtol=1e-5)
        toks, steps = [], []
        tok = logits.argmax(-1)[:, None]
        for _ in range(GEN):
            toks.append(tok[:, 0].numpy())
            logits, state = models.decode_step(model, state, tok, cfg)
            steps.append(logits.numpy())
            tok = logits.argmax(-1)[:, None]
    np.testing.assert_array_equal(np.stack(toks, 1), jtoks)
    for ours, theirs in zip(steps, jsteps):
        np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-4)


def test_forward_prefill_and_decode_match_reference_bf16():
    jcfg, cfg, jparams, model = _pair("bfloat16")
    tokens, _, frames = _inputs(cfg, seed=3)
    ref = np.asarray(_jit_forward(jcfg)(jparams, jnp.asarray(tokens), jnp.asarray(frames)))
    jcfg32, _ = _cfgs("float32")
    ref32 = np.asarray(_jit_forward(jcfg32)(jparams, jnp.asarray(tokens), jnp.asarray(frames)))
    budget = 2 * np.abs(ref - ref32).max()  # twice the reference's own bf16 error
    (jlogits, _), jtoks, jsteps = _reference_serve(jcfg, jparams, tokens, frames)
    with torch.no_grad():
        logits, _ = models.forward(model, {"tokens": tokens, "frames": frames}, cfg)
        state = models.init_decode_state(cfg, B, S + GEN, device="cpu")
        last, state = models.prefill(model, state, {"tokens": tokens, "frames": frames}, cfg)
        # the reference's tokens fed in: each step's logits held to its
        steps = [models.decode_step(model, state, torch.from_numpy(jtoks[:, :1]).long(), cfg)[0]]
    assert 0 < budget < 0.05 * np.abs(ref32).max()
    assert state["cross"]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(logits.numpy(), ref, atol=budget, rtol=0)
    np.testing.assert_allclose(last.numpy(), jlogits, atol=budget, rtol=0)
    np.testing.assert_allclose(steps[0].float().numpy(), jsteps[0], atol=budget, rtol=0)


@functools.lru_cache(maxsize=None)
def _reference_value_and_grad(jcfg):
    return jax.jit(jax.value_and_grad(lambda p, b: jlm_loss(p, b, jcfg), has_aux=True))


def _hold_grads(grads, jgrads, cfg):
    want = convert.lm_from_jax(_flatten(jgrads), cfg, device="cpu")
    assert set(grads) == set(want)
    for name, g in grads.items():
        scale = float(want[name].abs().max())
        err = float((g - want[name]).abs().max())
        assert scale > 0, name
        assert err <= 1e-4 * scale + 1e-9, f"{name}: {err:.3e} beyond 1e-4 x {scale:.3e}"


@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_gradients_match_reference(remat):
    """With remat every encoder and decoder layer is a ``RecomputeGroupFn``;
    a decoder layer's takes the encoder's output as an input, so the
    encoder's gradient comes through every layer's cross K/V, as
    ``jax.checkpoint`` of a body closing over it gives."""
    jcfg, cfg = _cfgs(remat=remat)
    jparams = fill_params(jcfg)
    tokens, labels, frames = _inputs(cfg, seed=5)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
              "frames": jnp.asarray(frames)}
    (jloss, jce), jgrads = _reference_value_and_grad(jcfg)(jparams, jbatch)
    params = convert.lm_from_jax(_flatten(jparams), cfg, device="cpu")
    with torch.device("meta"):
        model = models.init_model(cfg, generator=None, device="meta")
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long(),
             "frames": torch.from_numpy(frames)}
    calls = []
    apply = T.RecomputeGroupFn.apply
    T.RecomputeGroupFn.apply = lambda *a: calls.append(len(a)) or apply(*a)
    try:
        grads, (loss, ce) = torch.func.grad_and_value(
            lambda p: lm_loss(model, p, batch, cfg), has_aux=True)(params)
    finally:
        T.RecomputeGroupFn.apply = apply
    assert bool(calls) == remat
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-5)
    _hold_grads(grads, jgrads, cfg)


def test_weights_and_checkpoints_cross_both_ways(tmp_path):
    """``encoder/...`` and ``decoder/...`` (each layer on the leading axis)
    map to ``encoder.i.*`` and ``decoder.i.*``; a v1 params npz written by
    either package restores in the other, the same bits."""
    jcfg, cfg = _cfgs("bfloat16")
    jparams = fill_params(jcfg, seed=7)
    flat = _flatten(jparams)
    ported = convert.lm_from_jax(flat, cfg, device="cpu")
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert sorted(ported) == sorted(model.state_dict())
    assert torch.equal(ported["decoder.1.cross.wk.weight"],
                       torch.from_numpy(flat["decoder/cross/wk"][1].T.copy()))
    assert torch.equal(ported["encoder.1.ln2.scale"],
                       torch.from_numpy(flat["encoder/ln2/scale"][1].copy()))
    model.load_state_dict(ported)
    for back in (convert.lm_to_jax(ported, cfg), convert.lm_to_jax(model, cfg)):
        assert sorted(back) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(back[k], flat[k])
    ref_path, port_path = str(tmp_path / "ref"), str(tmp_path / "port")
    jck.save(ref_path, jparams, step=3)
    params, meta = ck.restore(ref_path, dict(model.named_parameters()), cfg=cfg)
    assert meta["step"] == 3 and all(torch.equal(params[k], ported[k]) for k in ported)
    ck.save(port_path, params, step=3, cfg=cfg)
    jback, _ = jck.restore(port_path, jax.tree.map(jnp.zeros_like, jparams))
    for k, a in _flatten(jback).items():
        np.testing.assert_array_equal(a, flat[k])


def test_two_train_steps_match_reference(tmp_path):
    """Two ``build_train_step`` steps of reduced whisper with remat, 2 peers
    x 2 rows of 16 tokens and 64 frames each (the frames split by peer as
    the tokens are), against the reference's 2-device step, free-running."""
    reference = run_reference_steps(tmp_path, ARCH, remat=True)
    cfg = reduced(get_config(ARCH), dtype="float32", remat=True)
    state = hold_steps_to_reference(reference, cfg)
    assert all(bool(torch.isfinite(p).all()) for p in state.params.values())
