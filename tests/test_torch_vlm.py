"""The port's VLM stub (internvl2-26b) against the reference's, on the CPU.

The model is ``reduced(internvl2-26b)``: 2 layers, d_model 128, 4 heads of
32 over 2 KV heads, vocabulary 512, 16 vision tokens. The stubbed vision
encoder's patch embeddings (B, 16, d) are seeded normals; the ``projector``
(d, d) maps them and they go before the token embeddings, at positions
0..15, and the forward's logits cover the S text positions only. Weights:
a seeded numpy fill of every reference leaf
(``test_torch_train_steps.fill_params``), carried across by
``convert.lm_from_jax``.

Tolerances as in ``tests/test_torch_lm.py``: in f32 the logits within
atol 1e-4 and rtol 1e-4, the KV caches within 1e-5, greedy tokens
identical; in the config's bf16 the forward and prefill logits within
twice the reference's own bf16 error. The loss within rtol 1e-5 and each
gradient leaf within 1e-4 of its largest magnitude, with remat on and off.
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
from repro.train import checkpoint as jck
from repro.train.checkpoint import _flatten
from repro.train.steps import lm_loss as jlm_loss
from repro_torch import convert, models
from repro_torch.configs import get_config, reduced
from repro_torch.train import checkpoint as ck
from repro_torch.train import lm_loss
from test_torch_train_steps import fill_params

torch.set_num_threads(2)  # the test workers share the CPU with each other

ARCH = "internvl2-26b"
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


def _inputs(cfg, seed=1, rows=B):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(rows, S + 1)).astype(np.int32)
    patches = rng.normal(size=(rows, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return tokens[:, :-1], tokens[:, 1:], patches


@functools.lru_cache(maxsize=None)
def _jit_forward(jcfg):
    return jax.jit(lambda p, b: jmodels.forward(p, b, jcfg)[0])


def _jbatch(tokens, patches=None):
    return {"tokens": jnp.asarray(tokens),
            **({} if patches is None else {"patches": jnp.asarray(patches)})}


@pytest.mark.parametrize("with_patches", [True, False])
def test_forward_matches_reference_f32(with_patches):
    """With patches the logits cover the S text positions; without, the
    VLM is the plain decoder LM, as in the reference."""
    jcfg, cfg, jparams, model = _pair()
    tokens, _, patches = _inputs(cfg)
    patches = patches if with_patches else None
    ref = np.asarray(_jit_forward(jcfg)(jparams, _jbatch(tokens, patches)))
    batch = {"tokens": tokens, **({} if patches is None else {"patches": patches})}
    with torch.no_grad():
        logits, aux = models.forward(model, batch, cfg)
    assert logits.shape == (B, S, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_vision_prefix_changes_text_logits():
    """The reference's ``tests/test_models.py`` behaviour, in the port."""
    _, cfg, _, model = _pair()
    tokens, _, p1 = _inputs(cfg, seed=2)
    _, _, p2 = _inputs(cfg, seed=3)
    with torch.no_grad():
        l1, _ = models.forward(model, {"tokens": tokens, "patches": p1}, cfg)
        l2, _ = models.forward(model, {"tokens": tokens, "patches": p2}, cfg)
    assert l1.shape == (B, S, cfg.vocab_size)
    assert float((l1 - l2).abs().max()) > 1e-3


def _reference_serve(jcfg, jparams, tokens, patches):
    state = jmodels.init_decode_state(jcfg, B, jcfg.vision_tokens + S + GEN)
    logits, state = jax.jit(lambda p, s, b: jmodels.prefill(p, s, b, jcfg))(
        jparams, state, _jbatch(tokens, patches))
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
    """Prefill of the patches and the prompt (V + S positions) into the KV
    caches, its last logits equal to the forward's last row, then 4 greedy
    decode steps from position V + S."""
    jcfg, cfg, jparams, model = _pair()
    tokens, _, patches = _inputs(cfg, seed=4)
    (jlogits, jstate), jtoks, jsteps = _reference_serve(jcfg, jparams, tokens, patches)
    V = cfg.vision_tokens
    batch = {"tokens": tokens, "patches": patches}
    with torch.no_grad():
        full, _ = models.forward(model, batch, cfg)
        state = models.init_decode_state(cfg, B, V + S + GEN, device="cpu")
        logits, state = models.prefill(model, state, batch, cfg)
        np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), atol=1e-4, rtol=1e-4)
        assert state["pos"] == int(jstate["pos"]) == V + S
        for layer, cache in enumerate(state["layers"]):  # period 1: layer g is group g
            for k in ("k", "v"):
                np.testing.assert_allclose(cache[k].numpy(), jstate["layers"][0][k][layer],
                                           atol=1e-5, rtol=1e-5)
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


def test_forward_and_prefill_match_reference_bf16():
    jcfg, cfg, jparams, model = _pair("bfloat16")
    tokens, _, patches = _inputs(cfg, seed=5)
    ref = np.asarray(_jit_forward(jcfg)(jparams, _jbatch(tokens, patches)))
    jcfg32, _ = _cfgs("float32")
    ref32 = np.asarray(_jit_forward(jcfg32)(jparams, _jbatch(tokens, patches)))
    budget = 2 * np.abs(ref - ref32).max()  # twice the reference's own bf16 error
    (jlogits, _), _, _ = _reference_serve(jcfg, jparams, tokens, patches)
    batch = {"tokens": tokens, "patches": patches}
    with torch.no_grad():
        logits, _ = models.forward(model, batch, cfg)
        state = models.init_decode_state(cfg, B, cfg.vision_tokens + S, device="cpu")
        last, _ = models.prefill(model, state, batch, cfg)
    assert 0 < budget < 0.05 * np.abs(ref32).max()
    np.testing.assert_allclose(logits.numpy(), ref, atol=budget, rtol=0)
    np.testing.assert_allclose(last.numpy(), jlogits, atol=budget, rtol=0)


@functools.lru_cache(maxsize=None)
def _reference_value_and_grad(jcfg):
    return jax.jit(jax.value_and_grad(lambda p, b: jlm_loss(p, b, jcfg), has_aux=True))


@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_gradients_match_reference(remat):
    """The loss over the S text positions of a batch with patches; the
    projector's gradient comes through every layer's attention to the
    prefix."""
    jcfg, cfg = _cfgs(remat=remat)
    jparams = fill_params(jcfg)
    tokens, labels, patches = _inputs(cfg, seed=6)
    (jloss, jce), jgrads = _reference_value_and_grad(jcfg)(
        jparams, dict(_jbatch(tokens, patches), labels=jnp.asarray(labels)))
    params = convert.lm_from_jax(_flatten(jparams), cfg, device="cpu")
    with torch.device("meta"):
        model = models.init_model(cfg, generator=None, device="meta")
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long(),
             "patches": torch.from_numpy(patches)}
    grads, (loss, ce) = torch.func.grad_and_value(
        lambda p: lm_loss(model, p, batch, cfg), has_aux=True)(params)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-5)
    want = convert.lm_from_jax(_flatten(jgrads), cfg, device="cpu")
    assert set(grads) == set(want)
    for name, g in grads.items():
        scale = float(want[name].abs().max())
        err = float((g - want[name]).abs().max())
        assert scale > 0 and err <= 1e-4 * scale + 1e-9, f"{name}: {err:.3e} of {scale:.3e}"


def test_projector_crosses_both_ways(tmp_path):
    """The reference's ``projector`` (din, dout) is the port's linear
    ``projector.weight`` (dout, din); every leaf goes across and back, and
    through a v1 params npz written by either package, the same bits."""
    jcfg, cfg = _cfgs("bfloat16")
    jparams = fill_params(jcfg, seed=7)
    flat = _flatten(jparams)
    ported = convert.lm_from_jax(flat, cfg, device="cpu")
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert sorted(ported) == sorted(model.state_dict())
    assert torch.equal(ported["projector.weight"], torch.from_numpy(flat["projector"].T.copy()))
    model.load_state_dict(ported)
    for back in (convert.lm_to_jax(ported, cfg), convert.lm_to_jax(model, cfg)):
        assert sorted(back) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(back[k], flat[k])
    ref_path, port_path = str(tmp_path / "ref"), str(tmp_path / "port")
    jck.save(ref_path, jparams, step=2)
    params, meta = ck.restore(ref_path, dict(model.named_parameters()), cfg=cfg)
    assert meta["step"] == 2 and all(torch.equal(params[k], ported[k]) for k in ported)
    ck.save(port_path, params, step=2, cfg=cfg)
    jback, _ = jck.restore(port_path, jax.tree.map(jnp.zeros_like, jparams))
    for k, a in _flatten(jback).items():
        np.testing.assert_array_equal(a, flat[k])
