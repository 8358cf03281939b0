"""What the flash forward saves for its backward, and the backward that
reads it, on the CPU (``kernels/flash_attention.py``).

``flash_attention_stats_plain`` (the plain twin of the forward kernel's
saved o in f32 and row log-sum-exp ``lse``) against a numpy log-sum-exp
(f64) of the reference's masked, softcapped scores and against the
reference's ``attend`` (``repro/models/layers.py:188``) output: causal,
windowed, softcapped, GQA, non-causal with ragged lengths. A row with no
valid key gets lse = -inf and o = 0.

``flash_attention_backward_saved_plain`` (the plain twin of the bf16
backward kernels, from q, k, v, lse and do) fed the numpy lse: equal to
``flash_attention_backward_plain`` and to ``jax.grad`` of ``attend``
within 2e-6 of each gradient's largest magnitude (sums in other orders,
f32); an error of lse shared along a row scales that row's gradients and
adds nothing (its delta is divided by the row's sum of p).

``FlashAttentionFn``'s outputs (o, o in f32, lse) under ``torch.func.vmap``
over peers: one call of the wrapper on plain tensors with the peers folded
into the batch, each output equal to a loop over the peers; under
``torch.inference_mode()`` nothing is saved. On a card (skipped here): the
bf16 forward kernel's lse and o in f32 against the plain twin.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._C._functorch import is_batchedtensor, is_gradtrackingtensor

from repro.models.layers import attend as jattend
from repro_torch.kernels import flash_attention as K

torch.set_num_threads(2)  # the test workers share the CPU with each other

CASES = {  # name -> (B, Sq, Skv, H, K, D, causal, softcap, window)
    "causal": (2, 40, 40, 4, 4, 32, True, 0.0, 0),
    "window": (1, 70, 70, 4, 2, 32, True, 0.0, 16),
    "softcap_gqa": (2, 33, 33, 8, 2, 64, True, 5.0, 0),
    "gqa_window_softcap": (1, 100, 100, 8, 2, 32, True, 3.0, 24),
    "noncausal_ragged": (2, 37, 53, 6, 3, 32, False, 2.0, 0),
    "causal_sq_lt_skv": (1, 30, 45, 2, 1, 64, True, 0.0, 0),
}
TOL = 2e-6  # of each gradient's (or output's) largest magnitude, f32


def _inputs(B, Sq, Skv, H, Kh, D, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s, sd: (rng.standard_normal(s) * sd).astype(np.float32)
    return r(B, Sq, H, D, sd=1.5), r(B, Skv, Kh, D, sd=1.5), r(B, Skv, Kh, D, sd=0.5), \
        r(B, Sq, H, D, sd=1.0)


def _numpy_lse(q, k, causal, cap, window):
    """log sum_j exp(s_ij) over the valid keys in f64: the kernels' scores
    (q_i / sqrt(D)) . k_j, softcapped, masked (-inf on a row with none)."""
    B, Sq, H, D = q.shape
    Kh = k.shape[2]
    kk = np.repeat(k.astype(np.float64), H // Kh, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64) / np.sqrt(D), kk)
    if cap:
        s = np.tanh(s / cap) * cap
    i, j = np.arange(Sq)[:, None], np.arange(k.shape[1])[None, :]
    valid = ((i >= j) & ((i - j < window) if window else True)) if causal else (j >= 0)
    s = np.where(valid, s, -np.inf)
    m = s.max(axis=-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):
        return (np.log(np.exp(s - m).sum(axis=-1)) + m[..., 0]).astype(np.float32)


def _reference(q, k, v, do, causal, cap, window):
    """The reference's attend at arange positions (window only when
    causal, as the kernels) -> (o, jax.grad against do)."""
    def f(q, k, v):
        return jattend(q, k, v, causal=causal, q_positions=jnp.arange(q.shape[1]),
                       kv_positions=jnp.arange(k.shape[1]), window=window if causal else 0,
                       softcap_val=cap)

    o, vjp = jax.vjp(f, q, k, v)
    return np.array(o), [np.array(g) for g in vjp(jnp.asarray(do))]


def _close(a, b, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= TOL * scale, f"{what}: {err:.3e} > {TOL} x {scale:.3e}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_stats_match_numpy_lse_and_the_reference(case):
    B, Sq, Skv, H, Kh, D, causal, cap, window = CASES[case]
    q, k, v, do = _inputs(B, Sq, Skv, H, Kh, D, seed=len(case))
    o, lse = K.flash_attention_stats_plain(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                           softcap=cap, window=window)
    assert o.dtype == lse.dtype == torch.float32
    assert tuple(o.shape) == q.shape and tuple(lse.shape) == (B, H, Sq)
    want = _numpy_lse(q, k, causal, cap, window)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=2e-6)
    ref_o, _ = _reference(q, k, v, do, causal, cap, window)
    _close(o, ref_o, f"{case}: o")


def test_a_row_with_no_valid_key_gets_minus_inf_and_zero():
    """Causal with a window and Sq > Skv + window - 1: rows 20.. see no key."""
    q, k, v, _ = _inputs(1, 30, 12, 2, 1, 32, seed=3)
    o, lse = K.flash_attention_stats_plain(*map(torch.from_numpy, (q, k, v)), window=8)
    assert torch.all(lse[..., 19:] == -torch.inf) and torch.all(torch.isfinite(lse[..., :19]))
    assert torch.all(o[:, 19:] == 0)
    np.testing.assert_allclose(lse.numpy(), _numpy_lse(q, k, True, 0.0, 8), rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_saved_form_backward_matches_the_plain_backward_and_jax_grad(case):
    B, Sq, Skv, H, Kh, D, causal, cap, window = CASES[case]
    q, k, v, do = _inputs(B, Sq, Skv, H, Kh, D, seed=len(case) + 1)
    ref_o, ref_grads = _reference(q, k, v, do, causal, cap, window)
    lse = _numpy_lse(q, k, causal, cap, window)
    got = K.flash_attention_backward_saved_plain(
        *map(torch.from_numpy, (q, k, v, lse, do)), causal=causal, softcap=cap,
        window=window)
    plain = K.flash_attention_backward_plain(*map(torch.from_numpy, (q, k, v, do)),
                                             causal=causal, softcap=cap, window=window)
    assert [tuple(g.shape) for g in got] == [q.shape, k.shape, v.shape]
    for name, a, b, r in zip("qkv", got, plain, ref_grads):
        _close(a, b.numpy(), f"{case} d{name}: saved form vs plain backward")
        _close(a, r, f"{case} d{name}: saved form vs jax.grad")


def test_saved_form_delta_takes_out_an_error_of_lse():
    """lse off by eps on one query row (what the forward's f32 statistics
    can carry): that row's p scales by exp(-eps) and its delta does not
    move, so its dq and its dv and dk terms scale by exp(-eps) and the rest
    stays; with delta = do . o from an exact o, dq would take eps delta
    sum_j p_ij k_j, large beside a dq whose dp - delta cancels."""
    B, Sq, H, Kh, D, causal, cap, window = 1, 24, 2, 1, 32, True, 3.0, 0
    q, k, v, do = map(torch.from_numpy, _inputs(B, Sq, Sq, H, Kh, D, seed=4))
    q, k, v, do = (t.double() for t in (q, k, v, do))
    _, lse = K.flash_attention_stats_plain(q, k, v, causal=causal, softcap=cap)
    eps, row = 1e-3, 17
    off = lse.clone()
    off[..., row] += eps
    base = K.flash_attention_backward_saved_plain(q, k, v, lse, do, causal=causal, softcap=cap)
    moved = K.flash_attention_backward_saved_plain(q, k, v, off, do, causal=causal, softcap=cap)
    want = base[0].clone()
    want[:, row] *= math.exp(-eps)
    torch.testing.assert_close(moved[0], want, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("causal,cap,window", [(True, 3.0, 10), (False, 0.0, 0)])
def test_vmap_rule_folds_the_peers_for_every_output(monkeypatch, causal, cap, window):
    P, B, S, H, Kh, D = 3, 2, 24, 4, 2, 32
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(P * B, S, S, H, Kh, D, seed=9))
    q, k, v = (t.unflatten(0, (P, B)) for t in (q, k, v))
    seen = []
    forward = K._forward

    def record(*args, **kw):
        tensors = [a for a in args if torch.is_tensor(a)]
        assert not any(is_batchedtensor(t) or is_gradtrackingtensor(t) for t in tensors)
        seen.append(tuple(tensors[0].shape))
        return forward(*args, **kw)

    monkeypatch.setattr(K, "_forward", record)
    outs = torch.func.vmap(lambda q, k, v: K.FlashAttentionFn.apply(q, k, v, causal, cap, window))(
        q, k, v)
    assert seen == [(P * B, S, H, D)]
    monkeypatch.setattr(K, "_forward", forward)
    loop = [K.FlashAttentionFn.apply(q[p], k[p], v[p], causal, cap, window) for p in range(P)]
    assert [tuple(t.shape) for t in outs] == [(P, B, S, H, D)] * 2 + [(P, B, H, S)]
    for got, name in zip(outs, ("o", "o32", "lse")):
        want = torch.stack([o[("o", "o32", "lse").index(name)] for o in loop])
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_inference_mode_saves_no_statistics():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 16, 16, 2, 1, 32, seed=2))
    with torch.inference_mode():
        o, o32, lse = K.FlashAttentionFn.apply(q, k, v, True, 0.0, 0)
    assert o32.numel() == lse.numel() == 0
    o2, o32, lse = K.FlashAttentionFn.apply(q, k, v, True, 0.0, 0)  # outside it
    assert torch.equal(o, o2) and tuple(o32.shape) == tuple(q.shape) and lse.shape == (1, 2, 16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")


@pytest.mark.parametrize("case", ["causal", "gqa_window_softcap", "noncausal_ragged"])
def test_cuda_forward_saves_the_plain_statistics(cuda, case):
    """The bf16 forward kernel's lse within 4e-6 |lse| + 2e-5 and o in f32
    within 2e-5 + 2e-4 |o| of the plain twin in f32 (as chip_smoke.py
    holds them)."""
    B, Sq, Skv, H, Kh, D, causal, cap, window = CASES[case]
    q, k, v, _ = (torch.from_numpy(a).cuda().to(torch.bfloat16)
                  for a in _inputs(B, Sq, Skv, H, Kh, D, seed=4))
    _, o32, lse = K.FlashAttentionFn.apply(q, k, v, causal, cap, window)
    ro, rl = K.flash_attention_stats_plain(q.float(), k.float(), v.float(), causal=causal,
                                           softcap=cap, window=window)
    assert torch.all((lse - rl).abs() <= 4e-6 * rl.abs() + 2e-5)
    assert torch.all((o32 - ro).abs() <= 2e-5 + 2e-4 * ro.abs())
