"""The port's flash attention against the reference's, on the CPU.

* ``flash_attention_plain`` (the kernel's plain version: the port's
  ``attend`` at ``arange`` positions) against the reference's Pallas
  ``flash_attention`` in interpret mode, at the reference's five shapes
  (``tests/test_kernels.py``), at gemma2's grouping (8 query heads over 4
  KV heads) with D = 256, softcap 50 and a window of 32 shorter than S, at
  Sq != Skv with a ragged KV tail, without causal masking (where the
  kernel ignores the window), and at two Pallas block sizes; and against
  the reference's oracle ``attention_ref`` where Sq = Skv. Tolerances are
  the reference's own Pallas-vs-oracle ones: f32 within atol 2e-5 and rtol
  2e-4, bf16 (the same bf16 inputs on both sides, computed in f32 and
  rounded once) within 2e-2.
* Rows with no valid key (causal, windowed, Sq > Skv + window - 1) are
  outside the parity contract: the test compares the other rows.
* The wrapper takes the plain version on the CPU, counts no launch, and
  refuses what the kernel does not take.

The CUDA kernel is held against the plain version by ``test_cuda_*``
(which skip without a card) and by ``chip_smoke.py``: in f32 at the
reference's tolerance, in bf16 against the plain version's f32 result
within the one rounding to bf16 (2^-8 |o|) plus 2e-5 max|o|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ref import attention_ref
from repro_torch.kernels import flash_attention as K

torch.set_num_threads(2)  # the test workers share the CPU with each other

CASES = {  # name -> B, Sq, Skv, H, Kh, D, causal, softcap, window, block_q, block_kv
    # tests/test_kernels.py's five
    "ref-gqa": (2, 64, 64, 4, 2, 32, True, 0.0, 0, 32, 32),
    "ref-softcap": (1, 128, 128, 4, 4, 64, True, 50.0, 0, 64, 32),
    "ref-window": (2, 96, 96, 8, 2, 32, True, 0.0, 32, 32, 32),
    "ref-padded": (1, 100, 100, 4, 1, 32, True, 0.0, 0, 32, 32),
    "ref-mha-128": (1, 64, 64, 8, 8, 128, True, 0.0, 0, 64, 64),
    # gemma2-2b's grouping and head size, softcap, a window shorter than S
    "gemma2-blocks32": (1, 96, 96, 8, 4, 256, True, 50.0, 32, 32, 32),
    "gemma2-blocks64": (1, 96, 96, 8, 4, 256, True, 50.0, 32, 64, 64),
    # Sq != Skv, the KV tail ragged against the blocks
    "sq<skv-ragged": (1, 40, 100, 4, 2, 32, True, 0.0, 0, 32, 32),
    "sq>skv-ragged": (1, 100, 40, 4, 2, 64, True, 20.0, 0, 32, 32),
    # without causal masking the kernel ignores the window
    "noncausal-window": (2, 48, 80, 4, 2, 32, False, 0.0, 16, 32, 32),
    "noncausal-window-blocks16": (1, 48, 80, 4, 2, 32, False, 10.0, 16, 16, 16),
}


def _inputs(B, Sq, Skv, H, Kh, D, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, Sq, H, D)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(B, Skv, Kh, D)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(B, Skv, Kh, D)) * 0.5).astype(np.float32)
    return q, k, v


def _pallas(arrays, causal, softcap, window, bq, bkv, dtype=jnp.float32):
    q, k, v = (jnp.asarray(a).astype(dtype) for a in arrays)
    out = pallas_flash(q, k, v, causal=causal, softcap=softcap, window=window, block_q=bq,
                       block_kv=bkv, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_and_oracle(case):
    B, Sq, Skv, H, Kh, D, causal, cap, window, bq, bkv = CASES[case]
    arrays = _inputs(B, Sq, Skv, H, Kh, D, seed=len(case))
    ref = _pallas(arrays, causal, cap, window, bq, bkv)
    out = K.flash_attention_plain(*map(torch.from_numpy, arrays), causal=causal, softcap=cap,
                                  window=window)
    assert out.shape == (B, Sq, H, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-4)
    if Sq == Skv:
        oracle = np.asarray(attention_ref(*map(jnp.asarray, arrays), causal=causal, softcap=cap,
                                          window=window if causal else 0))
        np.testing.assert_allclose(out.numpy(), oracle, atol=2e-5, rtol=2e-4)


def test_noncausal_window_is_ignored_where_attend_bounds_it():
    """Pinned difference: the Pallas kernel (and so the port's kernel and its
    plain version) ignores ``window`` without causal masking, while
    ``attend`` at the same positions keeps only |i - j| < window."""
    arrays = _inputs(1, 32, 32, 4, 2, 32, seed=9)
    q, k, v = map(torch.from_numpy, arrays)
    plain = K.flash_attention_plain(q, k, v, causal=False, window=8)
    assert torch.equal(plain, K.flash_attention_plain(q, k, v, causal=False))
    pos = torch.arange(32)
    bounded = K.attend(q, k, v, causal=False, q_positions=pos, kv_positions=pos, window=8)
    assert float((plain - bounded).abs().max()) > 1e-2


def test_rows_without_a_valid_key_are_outside_the_contract():
    """Causal with a window and Sq > Skv + window - 1: rows from
    Skv + window - 1 on see no key. The other rows match Pallas."""
    B, Sq, Skv, H, Kh, D, W = 1, 80, 40, 4, 2, 32, 16
    arrays = _inputs(B, Sq, Skv, H, Kh, D, seed=3)
    ref = _pallas(arrays, True, 0.0, W, 32, 32)
    out = K.flash_attention_plain(*map(torch.from_numpy, arrays), causal=True, window=W).numpy()
    live = Skv + W - 1
    np.testing.assert_allclose(out[:, :live], ref[:, :live], atol=2e-5, rtol=2e-4)
    assert np.all(np.isfinite(out))


@pytest.mark.parametrize("case", ["ref-gqa", "gemma2-blocks32", "sq<skv-ragged"])
def test_plain_bf16_matches_pallas(case):
    B, Sq, Skv, H, Kh, D, causal, cap, window, bq, bkv = CASES[case]
    arrays = _inputs(B, Sq, Skv, H, Kh, D, seed=11)
    ref = _pallas(arrays, causal, cap, window, bq, bkv, dtype=jnp.bfloat16)
    q, k, v = (torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)))
               .to(torch.bfloat16) for a in arrays)
    out = K.flash_attention_plain(q, k, v, causal=causal, softcap=cap, window=window)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=2e-2)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_no_launch():
    q, k, v = map(torch.from_numpy, _inputs(2, 96, 96, 8, 4, 64, seed=2))
    before = K.flash_attention.launches
    out = K.flash_attention(q, k, v, softcap=50.0, window=32)
    assert K.flash_attention.launches == before
    assert torch.equal(out, K.flash_attention_plain(q, k, v, softcap=50.0, window=32))


def test_cpu_route_differentiates_like_the_plain_function():
    """On CPU tensors the wrapper's forward is the plain version and its
    backward the plain backward (``flash_attention_backward_plain``, the
    backward kernel's formula), bit for bit; its gradients are autograd's
    of ``flash_attention_plain`` within 2e-6 of their largest magnitude
    (the two formulas sum in other orders)."""
    arrays = _inputs(1, 40, 40, 4, 2, 32, seed=4)
    grads = []
    for fn in (K.flash_attention, K.flash_attention_plain):
        q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
        out = fn(q, k, v, softcap=20.0, window=16)
        do = torch.linspace(-1.0, 1.0, out.numel()).view(out.shape)
        (out * do).sum().backward()
        grads.append([t.grad for t in (q, k, v)])
    plain = K.flash_attention_backward_plain(*map(torch.from_numpy, arrays), do, softcap=20.0,
                                             window=16)
    for got, want, formula in zip(*grads, plain):
        assert got is not None and torch.equal(got, formula)
        assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = map(torch.from_numpy, _inputs(1, 16, 16, 6, 4, 32))
    with pytest.raises(ValueError, match="KV heads must divide"):
        K.flash_attention(q, k, v)
    q, k, v = map(torch.from_numpy, _inputs(1, 16, 16, 4, 2, 32))
    with pytest.raises(ValueError, match="share one dtype"):
        K.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="share one dtype"):
        K.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="must be 4-d"):
        K.flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="must both be"):
        K.flash_attention(q, k, v[:, :8])
    with pytest.raises(ValueError, match="at least one key"):
        K.flash_attention(q, k[:, :0], v[:, :0])
    with pytest.raises(ValueError, match="window must be"):
        K.flash_attention(q, k, v, window=-1)
    # meta tensors (the dry run) take the CUDA route: its checks, no launch
    launches = K.flash_attention.launches
    assert K.flash_attention(*(t.to("meta") for t in (q, k, v))).shape == q.shape
    assert K.flash_attention.launches == launches
    q, k, v = map(torch.from_numpy, _inputs(1, 16, 16, 4, 2, 48))
    with pytest.raises(ValueError, match="multiple of 32"):
        K.flash_attention(*(t.to("meta") for t in (q, k, v)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")


@pytest.mark.parametrize("needs_grad", ["q", "k", "v"])
def test_cuda_wrapper_differentiates_through_the_backward_kernel(cuda, needs_grad):
    """With grad mode on and an input requiring grad, the CUDA wrapper runs
    one forward launch, and the backward one launch of the backward kernel
    (never the plain backward); the gradient is within 2e-5 + 2e-4 |g| of
    the plain version's in f32."""
    q, k, v = (torch.from_numpy(a).cuda() for a in _inputs(1, 64, 64, 4, 2, 32, seed=6))
    args = {"q": q, "k": k, "v": v}
    args[needs_grad] = args[needs_grad].requires_grad_(True)
    do = torch.randn_like(q)
    before = (K.flash_attention.launches, K.flash_attention_backward.launches)
    out = K.flash_attention(**args, softcap=5.0, window=20)
    (got,) = torch.autograd.grad(out, (args[needs_grad],), do)
    torch.cuda.synchronize()
    assert (K.flash_attention.launches, K.flash_attention_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = K.flash_attention_backward_plain(q, k, v, do, softcap=5.0, window=20)["qkv".index(needs_grad)]
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda, case, dtype):
    B, Sq, Skv, H, Kh, D, causal, cap, window, _, _ = CASES[case]
    q, k, v = (torch.from_numpy(a).cuda().to(dtype) for a in _inputs(B, Sq, Skv, H, Kh, D, seed=5))
    out = K.flash_attention(q, k, v, causal=causal, softcap=cap, window=window)
    # the plain version in f32 on the same inputs: before the output's rounding
    ref = K.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal, softcap=cap,
                                  window=window)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=2e-5, rtol=2e-4)
    else:  # one rounding to bf16, 2^-8 |o|, beside f32 sums added in other orders
        err = (out.float() - ref).abs()
        assert bool(torch.all(err <= 2.0 ** -8 * ref.abs() + 2e-5 * ref.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_returns_zero_for_rows_without_a_valid_key(cuda, dtype):
    q, k, v = (torch.from_numpy(a).cuda().to(dtype) for a in _inputs(1, 80, 40, 4, 2, 32, seed=3))
    out = K.flash_attention(q, k, v, window=16)
    torch.cuda.synchronize()
    assert torch.equal(out[:, 40 + 16 - 1:], torch.zeros_like(out[:, 40 + 16 - 1:]))


def _fused_views(B, S, H, Kh, D, dtype, offset=0, seed=0):
    """q, k and v as strided views of one (B, S, offset + (H + 2 Kh) D)
    tensor, the first ``offset`` columns of each row left out."""
    x = np.random.default_rng(seed).normal(size=(B, S, offset + (H + 2 * Kh) * D)) * 0.5
    x = torch.from_numpy(x.astype(np.float32)).to(dtype)[..., offset:]
    return (x[..., :H * D].unflatten(-1, (H, D)), x[..., H * D:(H + Kh) * D].unflatten(-1, (Kh, D)),
            x[..., (H + Kh) * D:].unflatten(-1, (Kh, D)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_takes_strided_views(cuda, dtype):
    q, k, v = (t.cuda() for t in _fused_views(2, 150, 8, 4, 64, dtype, seed=4))
    assert not q.is_contiguous()
    out = K.flash_attention(q, k, v, softcap=50.0, window=40)
    ref = K.flash_attention_plain(q.float(), k.float(), v.float(), softcap=50.0, window=40)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs()
    if dtype == torch.float32:
        assert bool(torch.all(err <= 2e-5 + 2e-4 * ref.abs()))
    else:
        assert bool(torch.all(err <= 2.0 ** -8 * ref.abs() + 2e-5 * ref.abs().max()))


def test_tma_check_refuses_misaligned_bf16_views():
    # the bf16 body's TMA needs 16-byte base addresses and strides
    q, k, v = _fused_views(1, 8, 2, 1, 32, torch.bfloat16)
    K._check_tma(q, k, v)
    with pytest.raises(ValueError, match="16-byte boundary"):
        K._check_tma(*_fused_views(1, 8, 2, 1, 32, torch.bfloat16, offset=4))
    narrow = torch.zeros((1, 8, 2 * 32 + 4), dtype=torch.bfloat16)[..., :64].unflatten(-1, (2, 32))
    with pytest.raises(ValueError, match="stride in dimension 1"):
        K._check_tma(narrow, k, v)


def test_cuda_kernel_refuses_misaligned_bf16_views_before_launching(cuda):
    q, k, v = (t.cuda() for t in _fused_views(1, 64, 4, 2, 32, torch.bfloat16, offset=4))
    before = K.flash_attention.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        K.flash_attention(q, k, v)
    assert K.flash_attention.launches == before
