"""The port's dense LMs and attention layers against the reference's, on the CPU.

Models (weights: a seeded numpy fill of every reference leaf, carried
across by ``convert.lm_from_jax``):

* gemma2-2b, reduced to 3 layers (``attn_local``, ``attn``, ``attn_local``:
  one group of the period-2 slot pair and a tail layer), sliding window 64,
  tied embeddings, both logit softcaps, gelu; S = 96 so the window bites
  and prefill rolls the local layers' 64-token caches.
* qwen2.5-3b, reduced to 3 layers, QKV bias, untied, silu, with
  ``serve_window=32``: prefill and decode attend within 32 tokens, every
  cache holds 32 and rolls, and decode runs at positions past the window.
* starcoder2-3b, reduced to 2 layers, QKV bias, gelu, untied.

Tolerances, in f32 (``dtype="float32"``, the point being the algorithm):
logits within atol 1e-4 and rtol 1e-4, caches within 1e-5; XLA and
PyTorch sum the products in other orders. Greedy tokens are identical.
The full-sequence and prefill attention go through the flash kernel's
wrapper (its plain version on the CPU), once per layer, and decode does
not. Prefill and decode write the KV caches in place and return them, where
the reference returns new ones. In the config's own bf16 the two
frameworks round at other places, so forward and prefill logits are held
within twice the reference's own bf16 error (its bf16 logits against its
f32 logits), as in ``tests/test_torch_lm.py``.

Layers: RoPE, the gated MLP and ``attend`` (random positions with invalid
-1 slots, rolling-window positions, cross-style non-causal windows)
against the reference's within 1e-6 in f32.
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
from repro.train.checkpoint import _flatten
from repro_torch import convert, models
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_grouping

torch.set_num_threads(2)  # the test workers share the CPU with each other

B, GEN = 2, 8
ARCHS = {  # arch -> (reduced() overrides, prompt length)
    "gemma2-2b": (dict(num_layers=3), 96),
    "qwen2.5-3b": (dict(num_layers=3, serve_window=32), 40),
    "starcoder2-3b": (dict(num_layers=2), 40),
}


def _cfgs(arch, dtype=None):
    kw = dict(ARCHS[arch][0], **({"dtype": dtype} if dtype else {}))
    return jreduced(jget_config(arch), **kw), reduced(get_config(arch), **kw)


def _reference_params(jcfg, seed=0):
    shapes = jax.eval_shape(lambda: jmodels.init_model(jax.random.PRNGKey(0), jcfg))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    rng = np.random.default_rng(seed)
    arrays = []
    for path, sds in leaves:
        name = str(getattr(path[-1], "key", path[-1]))
        n = rng.normal(size=sds.shape)
        if name in convert._LM_LINEAR:
            a = n / np.sqrt(sds.shape[-2])
        elif name == "embed":
            a = n * 0.5
        elif name == "scale":
            a = 1.0 + 0.1 * n
        else:  # the attention biases
            a = 0.1 * n
        arrays.append(jnp.asarray(a, jnp.float32))
    return jax.tree_util.tree_unflatten(treedef, arrays)


def _pair(arch, dtype=None):
    jcfg, cfg = _cfgs(arch, dtype)
    jparams = _reference_params(jcfg)
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(convert.lm_from_jax(_flatten(jparams), cfg, device="cpu"))
    return jcfg, cfg, jparams, model.requires_grad_(False)


def _tokens(n, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, n)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jit_forward(jcfg):
    return jax.jit(lambda p, t: jmodels.forward(p, {"tokens": t}, jcfg)[0])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_matches_reference_f32(arch):
    jcfg, cfg, jparams, model = _pair(arch, "float32")
    tokens = _tokens(ARCHS[arch][1], cfg.vocab_size)
    ref = np.asarray(_jit_forward(jcfg)(jparams, jnp.asarray(tokens)))
    with torch.no_grad():
        logits, aux = models.forward(model, {"tokens": tokens}, cfg)
    assert logits.shape == (B, tokens.shape[1], cfg.vocab_size) and logits.dtype == torch.float32
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-4, rtol=1e-4)


def _reference_serve(jcfg, jparams, tokens):
    """The reference's prefill, then GEN greedy decode steps."""
    state = jmodels.init_decode_state(jcfg, B, tokens.shape[1] + GEN)
    logits, state = jax.jit(lambda p, s, t: jmodels.prefill(p, s, {"tokens": t}, jcfg))(
        jparams, state, jnp.asarray(tokens))
    step = jax.jit(lambda p, s, t: jmodels.decode_step(p, s, t, jcfg))
    first = (np.asarray(logits), jax.tree.map(np.asarray, state))
    toks, step_logits = [], []
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for _ in range(GEN):
        toks.append(np.asarray(tok)[:, 0])
        logits, state = step(jparams, state, tok)
        step_logits.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    return first, np.stack(toks, 1), step_logits


def _port_serve(model, cfg, tokens):
    """The port's prefill (its caches copied before decode writes them in
    place), then GEN greedy decode steps."""
    with torch.no_grad():
        state = models.init_decode_state(cfg, B, tokens.shape[1] + GEN, device="cpu")
        logits, state = models.prefill(model, state, {"tokens": tokens}, cfg)
        first = (logits.numpy(), [{k: t.clone() for k, t in c.items()} for c in state["layers"]],
                 state["pos"])
        toks, step_logits = [], []
        tok = logits.argmax(-1)[:, None]
        for _ in range(GEN):
            toks.append(tok[:, 0].numpy())
            logits, state = models.decode_step(model, state, tok, cfg)
            step_logits.append(logits.numpy())
            tok = logits.argmax(-1)[:, None]
    return first, np.stack(toks, 1), step_logits


def _reference_cache(jstate, cfg, layer):
    period, n_groups, _ = layer_grouping(cfg)
    P = len(period)
    if layer < n_groups * P:
        return {k: a[layer // P] for k, a in jstate["layers"][layer % P].items()}
    return jstate["tail"][layer - n_groups * P]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_greedy_decode_match_reference_f32(arch):
    jcfg, cfg, jparams, model = _pair(arch, "float32")
    tokens = _tokens(ARCHS[arch][1], cfg.vocab_size, seed=2)
    (jlogits, jstate), jtoks, jsteps = _reference_serve(jcfg, jparams, tokens)
    (logits, caches, pos), toks, steps = _port_serve(model, cfg, tokens)
    np.testing.assert_allclose(logits, jlogits, atol=1e-4, rtol=1e-4)
    assert pos == int(jstate["pos"]) == tokens.shape[1]
    assert len(caches) == cfg.num_layers
    rolled = 0
    for layer, cache in enumerate(caches):
        ref = _reference_cache(jstate, cfg, layer)
        rolled += cache["k"].shape[1] < tokens.shape[1]
        for k in ("k", "v"):
            assert cache[k].shape == ref[k].shape
            np.testing.assert_allclose(cache[k].numpy(), ref[k], atol=1e-5, rtol=1e-5)
    assert rolled == {"gemma2-2b": 2, "qwen2.5-3b": 3, "starcoder2-3b": 0}[arch]
    np.testing.assert_array_equal(toks, jtoks)
    for ours, theirs in zip(steps, jsteps):
        np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_and_prefill_match_reference_bf16(arch):
    jcfg, cfg, jparams, model = _pair(arch)
    assert cfg.dtype == "bfloat16"
    tokens = _tokens(ARCHS[arch][1], cfg.vocab_size, seed=3)
    ref = np.asarray(_jit_forward(jcfg)(jparams, jnp.asarray(tokens)))
    jcfg32, _ = _cfgs(arch, "float32")
    ref32 = np.asarray(_jit_forward(jcfg32)(jparams, jnp.asarray(tokens)))
    budget = 2 * np.abs(ref - ref32).max()  # twice the reference's own bf16 error
    (jlogits, _), _, _ = _reference_serve(jcfg, jparams, tokens)
    with torch.no_grad():
        logits, _ = models.forward(model, {"tokens": tokens}, cfg)
        state = models.init_decode_state(cfg, B, tokens.shape[1], device="cpu")
        last, _ = models.prefill(model, state, {"tokens": tokens}, cfg)
    assert 0 < budget < 0.05 * np.abs(ref32).max()
    np.testing.assert_allclose(logits.numpy(), ref, atol=budget, rtol=0)
    np.testing.assert_allclose(last.numpy(), jlogits, atol=budget, rtol=0)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_attention_goes_through_the_flash_wrapper_except_in_decode(arch, monkeypatch):
    """Every layer's full-sequence and prefill attention calls the flash
    kernel's wrapper once, with the layer's window; decode calls ``attend``
    over the cache. On the CPU the wrapper launches nothing."""
    _, cfg, _, model = _pair(arch, "float32")
    calls = []

    def counting(q, k, v, **kw):
        calls.append(kw["window"])
        return flash(q, k, v, **kw)

    flash = L.flash_attention
    monkeypatch.setattr(L, "flash_attention", counting)
    local = [b.spec.mixer == "attn_local" for b in model.layers]
    other = cfg.serve_window if cfg.sliding_window == 0 else 0  # a global layer with a cache
    tokens = _tokens(ARCHS[arch][1], cfg.vocab_size, seed=6)
    launches = flash.launches
    with torch.no_grad():
        models.forward(model, {"tokens": tokens}, cfg)
        assert calls == [cfg.sliding_window if x else 0 for x in local]
        calls.clear()
        state = models.init_decode_state(cfg, B, tokens.shape[1] + 2, device="cpu")
        logits, state = models.prefill(model, state, {"tokens": tokens}, cfg)
        assert calls == [cfg.sliding_window if x else other for x in local]
        calls.clear()
        models.decode_step(model, state, logits.argmax(-1)[:, None], cfg)
    assert calls == [] and flash.launches == launches


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_write_the_caches_in_place(arch):
    """The port's one departure from the reference's functional state:
    prefill and decode write the KV cache buffers they are given and return
    those same buffers, so a state kept from before a step sees the step."""
    _, cfg, _, model = _pair(arch, "float32")
    tokens = _tokens(ARCHS[arch][1], cfg.vocab_size, seed=7)
    P = tokens.shape[1]
    with torch.no_grad():
        state0 = models.init_decode_state(cfg, B, P + 2, device="cpu")
        buffers = [(c["k"], c["v"]) for c in state0["layers"]]
        logits, state1 = models.prefill(model, state0, {"tokens": tokens}, cfg)
        assert state1["pos"] == P and state0["pos"] == 0
        for (k, v), cache in zip(buffers, state1["layers"]):
            assert cache["k"] is k and cache["v"] is v and bool(k.abs().sum() > 0)
        kept = [c["k"].clone() for c in state1["layers"]]
        _, state2 = models.decode_step(model, state1, logits.argmax(-1)[:, None], cfg)
        assert state2["pos"] == P + 1 and state1["pos"] == P
        for (k, _), before, cache in zip(buffers, kept, state2["layers"]):
            slot = P % k.shape[1]
            assert cache["k"] is k
            assert not torch.equal(k[:, slot], before[:, slot])  # written through state1's buffer
            rest = torch.arange(k.shape[1]) != slot
            assert torch.equal(k[:, rest], before[:, rest])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_weights_round_trip_exactly(arch):
    jcfg, cfg = _cfgs(arch)
    flat = _flatten(_reference_params(jcfg, seed=4))
    ported = convert.lm_from_jax(flat, cfg, device="cpu")
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert sorted(ported) == sorted(model.state_dict())
    model.load_state_dict(ported)
    for back in (convert.lm_to_jax(ported, cfg), convert.lm_to_jax(model, cfg)):
        assert sorted(back) == sorted(flat)
        for k in flat:
            assert back[k].dtype == flat[k].dtype
            np.testing.assert_array_equal(back[k], flat[k])


def test_full_gemma2_layout_round_trips_exactly():
    """gemma2-2b's own period-2 stack (13 groups of attn_local, attn) at a
    narrow width: every leaf maps to its layer and back exactly."""
    kw = dict(num_layers=26, d_model=64, d_ff=64, vocab_size=256, head_dim=32)
    jcfg, cfg = jreduced(jget_config("gemma2-2b"), **kw), reduced(get_config("gemma2-2b"), **kw)
    assert layer_grouping(cfg)[1:] == (13, 0)
    flat = _flatten(_reference_params(jcfg, seed=5))
    ported = convert.lm_from_jax(flat, cfg, device="cpu")
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(ported)
    assert [b.spec.mixer for b in model.layers] == ["attn_local", "attn"] * 13
    np.testing.assert_array_equal(ported["layers.25.mixer.wq.weight"].numpy(),
                                  flat["stack/1/mixer/wq"][12].T)
    back = convert.lm_to_jax(model, cfg)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(theta, dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 5000, size=(7,)).astype(np.int32)
    jsin, jcos = JL.rope_tables(jnp.asarray(pos), 32, theta)
    sin, cos = L.rope_tables(torch.from_numpy(pos.astype(np.int64)), 32, theta)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=2e-6, rtol=0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=2e-6, rtol=0)
    # the rotation itself, on the same tables and the same x in the working type
    jx = jnp.asarray(x).astype(dtype)
    ref = np.asarray(JL.apply_rope(jx, jsin, jcos).astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    ours = L.apply_rope(tx, torch.from_numpy(np.array(jsin)), torch.from_numpy(np.array(jcos)))
    assert ours.dtype == tx.dtype
    np.testing.assert_array_equal(ours.float().numpy(), ref)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(1)
    d, f = 24, 40
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    w = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))}
    ref = np.asarray(JL.mlp_apply({k: jnp.asarray(a) for k, a in w.items()}, jnp.asarray(x), act))
    mlp = L.MLP(d, f, generator=torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    for k, a in w.items():
        getattr(mlp, k).weight.data = torch.from_numpy(a.T.copy())
    with torch.no_grad():
        ours = L.mlp_apply(mlp, torch.from_numpy(x), act)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=1e-5)


ATTEND_CASES = {  # name -> (Sq, Skv, H, K, causal, window, softcap, positions)
    "causal-invalid-slots": (6, 40, 4, 2, True, 0, 0.0, "random"),
    "rolling-window": (1, 16, 4, 1, True, 16, 50.0, "rolling"),
    "window-prefill": (30, 30, 8, 4, True, 8, 0.0, "arange"),
    "cross-window": (5, 20, 4, 4, False, 6, 0.0, "random"),
    "online-blocks": (3, 1100, 2, 1, True, 700, 20.0, "random"),
}


@pytest.mark.parametrize("case", sorted(ATTEND_CASES))
def test_attend_matches_reference(case):
    Sq, Skv, H, K, causal, window, cap, kind = ATTEND_CASES[case]
    rng = np.random.default_rng(len(case))
    q = (rng.normal(size=(2, Sq, H, 32)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(2, Skv, K, 32)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(2, Skv, K, 32)) * 0.5).astype(np.float32)
    if kind == "arange":
        qpos, kvpos = np.arange(Sq), np.arange(Skv)
    elif kind == "rolling":  # a decode step at position 37 over a rolling 16-slot cache
        pos, j = 37, np.arange(Skv)
        qpos, kvpos = np.array([pos]), pos - np.mod(pos - j, Skv)
    else:
        qpos = rng.integers(0, 2 * Skv, size=Sq)
        kvpos = np.where(rng.random(Skv) < 0.2, -1, rng.permutation(2 * Skv)[:Skv])
    qpos, kvpos = qpos.astype(np.int32), kvpos.astype(np.int32)
    ref = np.asarray(JL.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kvpos),
                               window=window, softcap_val=cap))
    ours = L.attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
                    q_positions=torch.from_numpy(qpos.astype(np.int64)),
                    kv_positions=torch.from_numpy(kvpos.astype(np.int64)), window=window,
                    softcap_val=cap)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=1e-5)


def test_rolling_decode_positions_floor_like_jax():
    """Slot j of a rolling W-slot cache holds position p - ((p - j) mod W):
    torch's % floors as jnp's does, also for p < j and past the window."""
    W, j = 16, np.arange(16)
    for p in (0, 5, 15, 16, 37, 1000):
        ours = p - torch.remainder(p - torch.arange(W), W)
        ref = np.asarray(p - jnp.mod(p - jnp.asarray(j), W))
        np.testing.assert_array_equal(ours.numpy(), ref)
        assert int(ours.max()) == p and int(ours.min()) == p - W + 1


def test_init_decode_state_sizes_caches_like_the_reference():
    for arch in sorted(ARCHS):
        jcfg, cfg = _cfgs(arch)
        seq = ARCHS[arch][1] + GEN
        ours = models.init_decode_state(cfg, B, seq, device="cpu")
        theirs = jmodels.init_decode_state(jcfg, B, seq)
        for layer, cache in enumerate(ours["layers"]):
            ref = _reference_cache(theirs, cfg, layer)
            assert cache["k"].shape == ref["k"].shape and cache["v"].shape == ref["v"].shape
            assert str(cache["k"].dtype).split(".")[-1] == str(ref["k"].dtype)


def test_unported_dense_features_are_refused():
    """Nothing of the attention layer is refused now: its cross branch
    (whisper's decoder), on starcoder2's QKV-biased layer (q with its
    bias, no RoPE), equals the reference's on the same inputs within 1e-6, through the flash wrapper
    for 4 queries and through ``attend`` for a decoding step."""
    jcfg, cfg, jparams, model = _pair("starcoder2-3b", "float32")
    rng = np.random.default_rng(9)
    x = rng.normal(size=(1, 4, cfg.d_model)).astype(np.float32)
    kv = [rng.normal(size=(1, 12, cfg.num_kv_heads, cfg.resolved_head_dim)).astype(np.float32)
          for _ in range(2)]
    p = jax.tree.map(lambda a: a[0], jparams["stack"][0]["mixer"])
    for rows, cache_pos in ((slice(None), None), (slice(3, 4), 3)):
        pos = np.arange(4)[rows]
        theirs, _ = JL.attention_apply(p, jnp.asarray(x[:, rows]), jcfg, positions=jnp.asarray(pos),
                                       cross_kv=tuple(jnp.asarray(a) for a in kv))
        with torch.no_grad():
            ours, _ = L.attention_apply(model.layers[0].mixer, torch.from_numpy(x[:, rows]), cfg,
                                        positions=torch.from_numpy(pos), cache_pos=cache_pos,
                                        cross_kv=tuple(torch.from_numpy(a) for a in kv))
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6, rtol=1e-5)
