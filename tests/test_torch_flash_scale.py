"""``flash_attention``'s ``scale`` (the Zamba2 release's (D / 2)^-1/2) on
the CPU: it reaches the plain forward, the saved statistics, both plain
backwards and the vmapped Function's forward and backward. Scaling the
scores by s is attending with q times s sqrt(D) at the default scale, so
each result is held to that, and to differ from the default scale's."""
import math

import pytest
import torch

from repro_torch.kernels import flash_attention as kf

torch.set_num_threads(2)  # the test workers share the CPU with each other

B, S, H, K, D = 2, 40, 4, 2, 32
SCALE = (D / 2) ** -0.5


def inputs(seed=7, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    rand = lambda *s: torch.randn(s, generator=g, dtype=dtype)
    return rand(B, S, H, D), rand(B, S, K, D), rand(B, S, K, D), rand(B, S, H, D)


def as_default(q):
    """q whose default-scale scores are q's scores at SCALE."""
    return q * (SCALE * math.sqrt(D))


@pytest.mark.parametrize("window", [0, 9])
def test_scale_reaches_the_plain_forward_and_statistics(window):
    q, k, v, _ = inputs()
    got = kf.flash_attention_plain(q, k, v, window=window, scale=SCALE)
    want = kf.flash_attention_plain(as_default(q), k, v, window=window)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    assert not torch.allclose(got, kf.flash_attention_plain(q, k, v, window=window), atol=1e-3)
    o, lse = kf.flash_attention_stats_plain(q, k, v, window=window, scale=SCALE)
    o_want, lse_want = kf.flash_attention_stats_plain(as_default(q), k, v, window=window)
    assert torch.allclose(o, o_want, atol=1e-12) and torch.allclose(lse, lse_want, atol=1e-12)


@pytest.mark.parametrize("backward", ["plain", "saved"])
def test_scale_reaches_the_plain_backwards(backward):
    q, k, v, do = inputs()
    if backward == "plain":
        run = lambda qq, sc: kf.flash_attention_backward_plain(qq, k, v, do, scale=sc)
    else:
        def run(qq, sc):
            _, lse = kf.flash_attention_stats_plain(qq, k, v, scale=sc)
            return kf.flash_attention_backward_saved_plain(qq, k, v, lse, do, scale=sc)
    dq, dk, dv = run(q, SCALE)
    dq0, dk0, dv0 = run(as_default(q), None)
    # d/dq of f(q c) is c f'(q c)
    assert torch.allclose(dq, dq0 * (SCALE * math.sqrt(D)), atol=1e-10)
    assert torch.allclose(dk, dk0, atol=1e-10) and torch.allclose(dv, dv0, atol=1e-10)
    assert not torch.allclose(dk, run(q, None)[1], atol=1e-3)


def test_scale_reaches_the_function_and_its_gradient():
    q, k, v, do = inputs(dtype=torch.float32)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = kf.flash_attention(q, k, v, scale=SCALE)
    grads = torch.autograd.grad(o, (q, k, v), do)
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o_ref = kf.attend(*ref, causal=True, q_positions=torch.arange(S), kv_positions=torch.arange(S),
                      scale=SCALE)
    want = torch.autograd.grad(o_ref, ref, do)
    assert torch.allclose(o, o_ref, atol=1e-5)
    assert all(torch.allclose(g, w, atol=1e-5) for g, w in zip(grads, want))
    # the Function itself in f64 (the wrapper takes f32 and bf16)
    f64 = [t.detach()[:1, :6].double().requires_grad_() for t in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: kf.FlashAttentionFn.apply(a, b, c, True, 0.0, 0, SCALE)[0], f64)


def test_scale_reaches_the_vmapped_forward_and_backward():
    """vmap(grad) over 3 peers (the P2P step's form: the Function's vmap rule
    folds them into the batch) equals a loop over the peers at the scale."""
    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(3, B, S, n, D, generator=g) for n in (H, K, K))

    def loss(q, k, v, sc):
        return (kf.flash_attention(q, k, v, scale=sc) ** 2).sum()

    grad = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)), in_dims=(0, 0, 0, None))
    got = grad(q, k, v, SCALE)
    for p in range(3):
        want = torch.func.grad(loss, argnums=(0, 1, 2))(q[p], k[p], v[p], SCALE)
        assert all(torch.allclose(a[p], b, atol=1e-5) for a, b in zip(got, want))
    default = grad(q, k, v, None)
    assert not torch.allclose(got[1], default[1], atol=1e-3)
    outs = torch.func.vmap(lambda a, b, c: kf.flash_attention(a, b, c, scale=SCALE))(q, k, v)
    assert torch.allclose(outs, torch.stack([kf.flash_attention(q[p], k[p], v[p], scale=SCALE)
                                             for p in range(3)]), atol=1e-6)
