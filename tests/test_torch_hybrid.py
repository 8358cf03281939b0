"""The port's zamba2 hybrid LM against the reference's, on the CPU.

The model is ``reduced(zamba2-1.2b)`` with 5 layers: a Mamba-2 layer and a
``shared_attn`` layer per period (``shared_attn_every=2``), so two groups
of the period and one Mamba-2 tail layer; both ``shared_attn`` layers
apply the one weight-tied ``shared_block`` (ln1, attention at window 0,
ln2, the dense MLP). Weights: a seeded numpy fill of every reference leaf
(``test_torch_train_steps.fill_params``), carried across by
``convert.lm_from_jax``.

Tolerances as in ``tests/test_torch_lm.py``: in f32 the logits within
atol 1e-4 and rtol 1e-4, states and caches within 1e-5, greedy tokens
identical; in the config's bf16 forward and prefill logits within twice
the reference's own bf16 error. The loss within rtol 1e-5 and each
gradient leaf within 1e-4 of its largest magnitude, with remat on and off;
the shared block's gradient is the sum over the layers that apply it.

Reference behaviour 23 (ROADMAP.md): a ``shared_attn`` layer owns an
``ln1``, ``ln2`` and ``ffn`` that nothing reads (the reference's
``_init_block`` makes them, its ``_block_apply`` never reads them); the
port keeps them, so that params, checkpoints and wire bytes match leaf for
leaf. Their gradients are exactly zero on both sides, and Adam leaves them
as they were, bit for bit.
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
from repro_torch.models import layers as L
from repro_torch.models.transformer import LM, layer_grouping
from repro_torch.train import checkpoint as ck
from repro_torch.train import lm_loss
from test_torch_train_steps import fill_params, hold_steps_to_reference, run_reference_steps

torch.set_num_threads(2)  # the test workers share the CPU with each other

ARCH = "zamba2-1.2b"
B, S, GEN = 2, 40, 8  # 40 = one SSD chunk of 32 and a ragged one
LAYERS = 5
DEAD = ("ln1.scale", "ln2.scale", "ffn.w_gate.weight", "ffn.w_up.weight", "ffn.w_down.weight")


def _cfgs(dtype="float32", **kw):
    kw = dict(dict(num_layers=LAYERS, dtype=dtype), **kw)
    return jreduced(jget_config(ARCH), **kw), reduced(get_config(ARCH), **kw)


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32"):
    jcfg, cfg = _cfgs(dtype)
    jparams = fill_params(jcfg)
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(convert.lm_from_jax(_flatten(jparams), cfg, device="cpu"))
    return jcfg, cfg, jparams, model.requires_grad_(False)


def _tokens(n, vocab, seed=1, rows=B):
    return np.random.default_rng(seed).integers(0, vocab, size=(rows, n)).astype(np.int32)


def _shared_layers(cfg):
    return [i for i, s in enumerate(cfg.block_specs()) if s.mixer == "shared_attn"]


def test_layout_is_two_groups_and_a_tail():
    _, cfg = _cfgs()
    period, n_groups, rem = layer_grouping(cfg)
    assert [s.mixer for s in period] == ["mamba", "shared_attn"] and (n_groups, rem) == (2, 1)
    assert _shared_layers(cfg) == [1, 3]
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert {n for n, _ in model.shared_block.named_parameters()} == {
        "ln1.scale", "mixer.wq.weight", "mixer.wk.weight", "mixer.wv.weight", "mixer.wo.weight",
        "ln2.scale", "ffn.w_gate.weight", "ffn.w_up.weight", "ffn.w_down.weight"}
    assert {n for n, _ in model.layers[1].named_parameters()} == set(DEAD)


@functools.lru_cache(maxsize=None)
def _jit_forward(jcfg):
    return jax.jit(lambda p, t: jmodels.forward(p, {"tokens": t}, jcfg)[0])


def test_forward_matches_reference_f32():
    jcfg, cfg, jparams, model = _pair()
    tokens = _tokens(S, cfg.vocab_size)
    ref = np.asarray(_jit_forward(jcfg)(jparams, jnp.asarray(tokens)))
    with torch.no_grad():
        logits, aux = models.forward(model, {"tokens": tokens}, cfg)
    assert logits.shape == (B, S, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-4, rtol=1e-4)


def _reference_serve(jcfg, jparams, tokens):
    state = jmodels.init_decode_state(jcfg, B, tokens.shape[1] + GEN)
    logits, state = jax.jit(lambda p, s, t: jmodels.prefill(p, s, {"tokens": t}, jcfg))(
        jparams, state, jnp.asarray(tokens))
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
    """Prefill fills each Mamba-2 layer's state and each ``shared_attn``
    layer's own KV cache (the shared weights, a cache per layer), then 8
    greedy decode steps."""
    jcfg, cfg, jparams, model = _pair()
    tokens = _tokens(S, cfg.vocab_size, seed=2)
    (jlogits, jstate), jtoks, jsteps = _reference_serve(jcfg, jparams, tokens)
    period, n_groups, _ = layer_grouping(cfg)
    P = len(period)
    with torch.no_grad():
        state = models.init_decode_state(cfg, B, S + GEN, device="cpu")
        logits, state = models.prefill(model, state, {"tokens": tokens}, cfg)
        np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4, rtol=1e-4)
        assert state["pos"] == int(jstate["pos"]) == S
        for layer, st in enumerate(state["layers"]):
            ref = ({k: a[layer // P] for k, a in jstate["layers"][layer % P].items()}
                   if layer < n_groups * P else jstate["tail"][layer - n_groups * P])
            assert sorted(st) == sorted(ref) == (["k", "v"] if layer in _shared_layers(cfg)
                                                 else ["conv", "ssm"])
            for k in st:
                np.testing.assert_allclose(st[k].numpy(), ref[k], atol=1e-5, rtol=1e-5)
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
    tokens = _tokens(S, cfg.vocab_size, seed=3)
    ref = np.asarray(_jit_forward(jcfg)(jparams, jnp.asarray(tokens)))
    jcfg32, _ = _cfgs("float32")
    ref32 = np.asarray(_jit_forward(jcfg32)(jparams, jnp.asarray(tokens)))
    budget = 2 * np.abs(ref - ref32).max()  # twice the reference's own bf16 error
    (jlogits, _), _, _ = _reference_serve(jcfg, jparams, tokens)
    with torch.no_grad():
        logits, _ = models.forward(model, {"tokens": tokens}, cfg)
        state = models.init_decode_state(cfg, B, S, device="cpu")
        last, _ = models.prefill(model, state, {"tokens": tokens}, cfg)
    assert 0 < budget < 0.05 * np.abs(ref32).max()
    np.testing.assert_allclose(logits.numpy(), ref, atol=budget, rtol=0)
    np.testing.assert_allclose(last.numpy(), jlogits, atol=budget, rtol=0)


def test_shared_attention_goes_through_the_flash_wrapper_at_window_0(monkeypatch):
    """Each ``shared_attn`` layer's full-sequence and prefill attention calls
    the flash kernel's wrapper once, at window 0; decode does not."""
    _, cfg, _, model = _pair()
    calls = []

    def counting(q, k, v, **kw):
        calls.append(kw["window"])
        return flash(q, k, v, **kw)

    flash = L.flash_attention
    monkeypatch.setattr(L, "flash_attention", counting)
    tokens = _tokens(S, cfg.vocab_size, seed=6)
    with torch.no_grad():
        models.forward(model, {"tokens": tokens}, cfg)
        assert calls == [0, 0]
        state = models.init_decode_state(cfg, B, S + 2, device="cpu")
        logits, state = models.prefill(model, state, {"tokens": tokens}, cfg)
        assert calls == [0, 0, 0, 0]
        models.decode_step(model, state, logits.argmax(-1)[:, None], cfg)
    assert calls == [0, 0, 0, 0]


@functools.lru_cache(maxsize=None)
def _reference_value_and_grad(jcfg):
    return jax.jit(jax.value_and_grad(lambda p, b: jlm_loss(p, b, jcfg), has_aux=True))


def _batch(cfg, rows=B, seed=5):
    toks = _tokens(S + 1, cfg.vocab_size, seed=seed, rows=rows)
    return toks[:, :-1], toks[:, 1:]


def _hold_grads(grads, jgrads, cfg):
    want = convert.lm_from_jax(_flatten(jgrads), cfg, device="cpu")
    assert set(grads) == set(want)
    for name, g in grads.items():
        scale = float(want[name].abs().max())
        err = float((g - want[name]).abs().max())
        assert err <= 1e-4 * scale + 1e-9, f"{name}: {err:.3e} beyond 1e-4 x {scale:.3e}"


def _dead(cfg):
    return [f"layers.{i}.{n}" for i in _shared_layers(cfg) for n in DEAD]


def _port_grads(cfg, jparams, tokens, labels):
    params = convert.lm_from_jax(_flatten(jparams), cfg, device="cpu")
    with torch.device("meta"):
        model = LM(cfg, generator=None, device="meta")
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    return params, model, batch


@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_gradients_match_reference(remat):
    """With remat each group is a ``RecomputeGroupFn`` whose inputs include
    the shared block's params: their gradient is the sum over both groups'
    uses, as ``jax.checkpoint`` of a body closing over them gives. The
    unread params of the ``shared_attn`` layers get exactly zero on both
    sides (reference behaviour 23)."""
    jcfg, cfg = _cfgs(remat=remat)
    jparams = fill_params(jcfg)
    tokens, labels = _batch(cfg)
    (jloss, jce), jgrads = _reference_value_and_grad(jcfg)(
        jparams, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    params, model, batch = _port_grads(cfg, jparams, tokens, labels)
    grads, (loss, ce) = torch.func.grad_and_value(
        lambda p: lm_loss(model, p, batch, cfg), has_aux=True)(params)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-5)
    _hold_grads(grads, jgrads, cfg)
    jflat = convert.lm_from_jax(_flatten(jgrads), cfg, device="cpu")
    for name in _dead(cfg):
        assert float(jflat[name].abs().max()) == 0.0 and float(grads[name].abs().max()) == 0.0
    assert float(grads["shared_block.mixer.wq.weight"].abs().max()) > 0


def test_per_peer_gradients_under_vmap_match_reference():
    """``vmap(grad)`` over 2 peers with remat: the shared block's params go
    into the Function as inputs under vmap, against ``jax.vmap(jax.grad)``."""
    jcfg, cfg = _cfgs(remat=True)
    jparams = fill_params(jcfg)
    tokens, labels = _batch(cfg, rows=2 * B, seed=6)
    split = lambda a: a.reshape(2, B, -1)
    jgrads = jax.jit(jax.vmap(jax.grad(lambda p, b: jlm_loss(p, b, jcfg)[0]), in_axes=(None, 0)))(
        jparams, {"tokens": jnp.asarray(split(tokens)), "labels": jnp.asarray(split(labels))})
    params, model, batch = _port_grads(cfg, jparams, split(tokens), split(labels))
    grads = torch.func.vmap(torch.func.grad(lambda p, b: lm_loss(model, p, b, cfg)[0]),
                            in_dims=(None, 0))(params, batch)
    for peer in range(2):
        _hold_grads({k: g[peer] for k, g in grads.items()},
                    jax.tree.map(lambda a: a[peer], jgrads), cfg)


def test_weights_and_checkpoints_cross_both_ways(tmp_path):
    """``shared_block/...`` maps to ``shared_block.*``, the unread slot
    params to the ``shared_attn`` layers; a v1 params npz written by either
    package restores in the other, the same bits."""
    jcfg, cfg = _cfgs("bfloat16")
    jparams = fill_params(jcfg, seed=7)
    flat = _flatten(jparams)
    ported = convert.lm_from_jax(flat, cfg, device="cpu")
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert sorted(ported) == sorted(model.state_dict())
    assert torch.equal(ported["shared_block.mixer.wq.weight"],
                       torch.from_numpy(flat["shared_block/mixer/wq"].T.copy()))
    assert torch.equal(ported["layers.3.ln2.scale"],
                       torch.from_numpy(flat["stack/1/ln2/scale"][1].copy()))
    model.load_state_dict(ported)
    for back in (convert.lm_to_jax(ported, cfg), convert.lm_to_jax(model, cfg)):
        assert sorted(back) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(back[k], flat[k])
    ref_path, port_path = str(tmp_path / "ref"), str(tmp_path / "port")
    jck.save(ref_path, jparams, step=5)
    params, meta = ck.restore(ref_path, dict(model.named_parameters()), cfg=cfg)
    assert meta["step"] == 5 and all(torch.equal(params[k], ported[k]) for k in ported)
    ck.save(port_path, params, step=5, cfg=cfg)
    jback, _ = jck.restore(port_path, jax.tree.map(jnp.zeros_like, jparams))
    for k, a in _flatten(jback).items():
        np.testing.assert_array_equal(a, flat[k])


def test_two_train_steps_match_reference(tmp_path):
    """Two ``build_train_step`` steps of reduced zamba2 with remat, through
    ``ssd_chunked`` (the reference's default), against the reference's
    2-device step (``test_torch_train_steps``' harness and tolerances),
    free-running; the unread slot params come out of both sides' Adam as
    they went in, bit for bit."""
    reference = run_reference_steps(tmp_path, ARCH, num_layers=LAYERS, remat=True)
    cfg = reduced(get_config(ARCH), num_layers=LAYERS, dtype="float32", remat=True)
    state = hold_steps_to_reference(reference, cfg)
    init = convert.lm_from_jax(reference("init/params"), cfg, device="cpu")
    final = convert.lm_from_jax(reference("final/params"), cfg, device="cpu")
    for name in _dead(cfg):
        assert torch.equal(final[name], init[name])
        assert torch.equal(state.params[name], init[name])
