"""The flash attention backward of the port against autograd and the
reference, on the CPU.

``flash_attention_backward_plain`` (the formula the backward kernel
computes) is held to ``torch.autograd`` of ``flash_attention_plain`` and
both to ``jax.grad`` of the reference's ``attend``
(``repro/models/layers.py:188``) at ``arange`` positions, the function the
flash kernels compute: causal, windowed, softcapped, GQA, non-causal and
ragged lengths, every query row with at least one valid key. In f32 the
two frameworks and the two formulas sum in other orders: within 2e-6 of
each gradient's largest magnitude. ``torch.autograd.gradcheck`` holds the
autograd Function's backward to finite differences in f64.

Under ``torch.func.vmap`` over a peer dimension, as the P2P step takes
per-peer gradients, the Function's vmap rules fold the peers into the
batch: the wrappers see plain tensors, and the gradients equal a loop
over the peers within 1e-6 (the batched products around the attention
may sum in another order).
"""
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
    "softcap": (2, 33, 33, 4, 2, 64, True, 5.0, 0),
    "gqa_window_softcap": (1, 100, 100, 8, 2, 32, True, 3.0, 24),
    "noncausal_ragged": (2, 37, 53, 6, 3, 32, False, 2.0, 0),
    "causal_sq_lt_skv": (1, 30, 45, 2, 1, 64, True, 0.0, 0),
}
TOL = 2e-6  # of each gradient's largest magnitude, f32


def _inputs(B, Sq, Skv, H, Kh, D, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s, sd: (rng.standard_normal(s) * sd).astype(np.float32)
    return r(B, Sq, H, D, sd=1.5), r(B, Skv, Kh, D, sd=1.5), r(B, Skv, Kh, D, sd=0.5), \
        r(B, Sq, H, D, sd=1.0)


def _reference_grads(q, k, v, do, causal, cap, window):
    """jax.grad of the reference's attend at arange positions, against the
    cotangent do; attend bounds |i - j| without causal masking, where the
    kernels ignore the window, so it gets the window only when causal."""
    def f(q, k, v):
        o = jattend(q, k, v, causal=causal, q_positions=jnp.arange(q.shape[1]),
                    kv_positions=jnp.arange(k.shape[1]), window=window if causal else 0,
                    softcap_val=cap)
        return jnp.sum(o * do)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


def _close(got, ref, what):
    for name, a, b in zip("qkv", got, ref):
        a = np.asarray(a, np.float32)
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        assert err <= TOL * scale, f"{what} d{name}: {err:.3e} > {TOL} x {scale:.3e}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_and_the_reference(case):
    B, Sq, Skv, H, Kh, D, causal, cap, window = CASES[case]
    q, k, v, do = _inputs(B, Sq, Skv, H, Kh, D, seed=len(case))
    ref = _reference_grads(q, k, v, do, causal, cap, window)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = K.flash_attention_plain(qt, kt, vt, causal=causal, softcap=cap, window=window)
    auto = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    plain = K.flash_attention_backward_plain(
        *(torch.from_numpy(a) for a in (q, k, v, do)), causal=causal, softcap=cap, window=window)
    assert [g.dtype for g in plain] == [torch.float32] * 3
    assert [tuple(g.shape) for g in plain] == [q.shape, k.shape, v.shape]
    _close([g.numpy() for g in plain], [g.numpy() for g in auto], f"{case}: plain vs autograd")
    _close([g.numpy() for g in plain], ref, f"{case}: plain vs jax.grad")
    _close([g.numpy() for g in auto], ref, f"{case}: autograd vs jax.grad")


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrapper_differentiates_through_the_plain_backward_on_the_cpu(case):
    """``flash_attention`` on CPU tensors: the Function's backward is
    ``flash_attention_backward_plain``, bit for bit, and the backward
    wrapper takes it; neither counts a kernel launch."""
    B, Sq, Skv, H, Kh, D, causal, cap, window = CASES[case]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, Sq, Skv, H, Kh, D, seed=7))
    before = (K.flash_attention.launches, K.flash_attention_backward.launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = K.flash_attention(*leaves, causal=causal, softcap=cap, window=window)
    got = torch.autograd.grad(o, leaves, do)
    plain = K.flash_attention_backward_plain(q, k, v, do, causal=causal, softcap=cap, window=window)
    wrapped = K.flash_attention_backward(q, k, v, do, causal=causal, softcap=cap, window=window)
    for a, b, c in zip(got, plain, wrapped):
        assert torch.equal(a, b) and torch.equal(b, c)
    assert (K.flash_attention.launches, K.flash_attention_backward.launches) == before


def test_bf16_inputs_give_bf16_gradients():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(1, 20, 20, 4, 2, 32, 3))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(K.flash_attention(*leaves, softcap=4.0), leaves, do)
    ref = K.flash_attention_backward_plain(*(t.float() for t in (q, k, v, do)), softcap=4.0)
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16
        # one rounding of the f32 result to bf16
        assert float((a.float() - b).abs().max()) <= 2.0 ** -8 * float(b.abs().max())


def test_gradcheck_in_f64():
    """The autograd Function (forward ``flash_attention_plain``, backward
    ``flash_attention_backward_plain``, both in f64 for f64 inputs) against
    finite differences, with causal masking, a window and a softcap."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 6, 4, 4), generator=g, dtype=torch.float64, requires_grad=True)
    k = torch.randn((1, 6, 2, 4), generator=g, dtype=torch.float64, requires_grad=True)
    v = torch.randn((1, 6, 2, 4), generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda q, k, v: K.FlashAttentionFn.apply(q, k, v, True, 2.0, 3), (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v: K.FlashAttentionFn.apply(q, k, v, False, 0.0, 0), (q, k, v))


def test_second_derivative_raises():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 2, 1, 32, 4))
    q.requires_grad_(True)
    (gq,) = torch.autograd.grad(K.flash_attention(q, k, v).sum(), (q,), create_graph=True)
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad(gq.sum(), (q,))


@pytest.mark.parametrize("causal,cap,window", [(True, 3.0, 10), (False, 0.0, 0)])
def test_vmapped_grad_folds_the_peers_into_the_batch(monkeypatch, causal, cap, window):
    """``vmap(grad(...))`` over 3 peers (the P2P step's per-peer gradients,
    one shared weight): equal to a loop over the peers, and each wrapper
    called once, on plain tensors whose batch holds every peer's rows."""
    P, B, S, H, Kh, D = 3, 2, 24, 4, 2, 32
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((P, B, S, 16)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((16, (H + 2 * Kh) * D)) * 0.3).astype(np.float32))
    seen = []
    fwd, bwd = K._forward, K._backward

    def record(fn, tag):
        def wrapped(*args, **kw):
            tensors = [a for a in args if torch.is_tensor(a)]
            assert not any(is_batchedtensor(t) or is_gradtrackingtensor(t) for t in tensors)
            seen.append((tag, tuple(tensors[0].shape)))
            return fn(*args, **kw)
        return wrapped

    def loss(w, x):
        qkv = (x @ w).unflatten(-1, (H + 2 * Kh, D))
        q, k, v = qkv[..., :H, :], qkv[..., H:H + Kh, :], qkv[..., H + Kh:, :]
        o = K.flash_attention(q, k, v, causal=causal, softcap=cap, window=window)
        return (o * o).sum()

    monkeypatch.setattr(K, "_forward", record(fwd, "forward"))
    monkeypatch.setattr(K, "_backward", record(bwd, "backward"))
    got = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(w, x)
    assert seen == [("forward", (P * B, S, H, D)), ("backward", (P * B, S, H, D))]
    looped = torch.stack([torch.func.grad(loss)(w, x[p]) for p in range(P)])
    assert got.shape == (P, *w.shape)
    torch.testing.assert_close(got, looped, rtol=0, atol=1e-6)
