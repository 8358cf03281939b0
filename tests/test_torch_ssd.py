"""The port's SSD scan against the reference's, on the CPU.

* ``ssd_scan_plain`` (the kernel's plain version, ``ssd_chunked``'s y)
  against the reference's Pallas ``ssd_scan_pallas`` in interpret mode and
  against its sequential oracle ``ssd_scan_ref`` (y, and ``ssd_chunked``'s
  final state against the oracle's), at the shapes of ``tests/test_kernels.py``:
  atol 2e-5 and rtol 2e-4 in f32, the tolerance of the reference's own
  Pallas-vs-oracle test (the chunked form sums in another order than the
  per-step recurrence). With bf16 inputs, the same tolerance against the
  Pallas kernel on the same bf16 values: both compute in f32.
* The port's ``ssd_chunked`` (y and the final state, with and without an
  initial state) and ``ssd_decode_step`` against the reference's: atol 1e-5
  and rtol 1e-5, f32 einsums summed in another order by XLA and PyTorch.
* ``causal_conv`` against the reference's: identical in f32 and bf16 (the
  same products and sums, each rounded in the working type).
* The wrapper takes the plain version on the CPU and counts no launch.

The CUDA kernel is held against the plain version by ``test_cuda_*``
(which skip without a card) and by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_scan_ref as jssd_scan_ref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import ssm as JS
from repro_torch.kernels import ssd_scan as K
from repro_torch.models import ssm as S

torch.set_num_threads(2)  # the test workers share the CPU with each other

SHAPES = [  # B, S, H, P, G, N, chunk — tests/test_kernels.py
    (1, 32, 2, 16, 1, 8, 16),
    (2, 96, 4, 32, 2, 16, 32),
    (2, 64, 4, 64, 1, 32, 64),
    (1, 80, 8, 32, 4, 16, 32),
]


def _inputs(B, S_, H, P, G, N, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, S_, H, P)) * 0.5).astype(np.float32)
    dt = (np.log1p(np.exp(rng.normal(size=(B, S_, H)))) * 0.2).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    Bm = (rng.normal(size=(B, S_, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.normal(size=(B, S_, G, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("B,S_,H,P,G,N,chunk", SHAPES)
def test_plain_matches_pallas_and_oracle(B, S_, H, P, G, N, chunk):
    arrays = _inputs(B, S_, H, P, G, N, seed=B * S_ + H)
    y_pallas = np.asarray(ssd_scan_pallas(*map(jnp.asarray, arrays), chunk=chunk))
    y_ref, h_ref = jssd_scan_ref(*map(jnp.asarray, arrays))
    y = K.ssd_scan_plain(*_torch(*arrays), chunk=chunk).numpy()
    assert y.shape == (B, S_, H, P) and y.dtype == np.float32
    np.testing.assert_allclose(y, y_pallas, atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(y, np.asarray(y_ref), atol=2e-5, rtol=2e-4)
    y_c, h_c = K.ssd_chunked(*_torch(*arrays), chunk)
    assert torch.equal(torch.from_numpy(y), y_c)
    np.testing.assert_allclose(h_c.numpy(), np.asarray(h_ref), atol=2e-5, rtol=2e-4)


def test_plain_bf16_inputs_match_pallas():
    B, S_, H, P, G, N = 1, 64, 2, 32, 1, 16
    x, dt, A, Bm, Cm = _inputs(B, S_, H, P, G, N, seed=7)
    jx, jB, jC = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, Bm, Cm))
    y_pallas = np.asarray(ssd_scan_pallas(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, chunk=32))
    tx, tB, tC = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (jx, jB, jC))
    y = K.ssd_scan_plain(tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC, chunk=32)
    np.testing.assert_allclose(y.numpy(), y_pallas, atol=2e-5, rtol=2e-4)
    # the wrapper takes the same bf16 inputs on the CPU
    np.testing.assert_array_equal(
        K.ssd_scan(tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC, chunk=32).numpy(),
        y.numpy())


@pytest.mark.parametrize("B,S_,H,P,G,N,chunk", SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(B, S_, H, P, G, N, chunk, with_state):
    arrays = _inputs(B, S_, H, P, G, N, seed=S_ + N)
    init = None
    if with_state:
        init = (np.random.default_rng(1).normal(size=(B, H, P, N)) * 0.2).astype(np.float32)
    jy, jfinal = JS.ssd_chunked(*map(jnp.asarray, arrays), chunk,
                                None if init is None else jnp.asarray(init))
    y, final = S.ssd_chunked(*_torch(*arrays), chunk, None if init is None else torch.from_numpy(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("H,G", [(4, 1), (8, 4)])
def test_ssd_decode_step_matches_reference(H, G):
    B, P, N = 2, 32, 16
    rng = np.random.default_rng(H + G)
    x = rng.normal(size=(B, H, P)).astype(np.float32)
    dt = (rng.random((B, H)) * 0.5).astype(np.float32)
    A = (-rng.random(H) * 4).astype(np.float32)
    Bm = rng.normal(size=(B, G, N)).astype(np.float32)
    Cm = rng.normal(size=(B, G, N)).astype(np.float32)
    st = rng.normal(size=(B, H, P, N)).astype(np.float32)
    jy, jst = JS.ssd_decode_step(*map(jnp.asarray, (x, dt, A, Bm, Cm, st)))
    y, new = S.ssd_decode_step(*_torch(x, dt, A, Bm, Cm, st))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(new.numpy(), np.asarray(jst), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 11, 24)).astype(np.float32)
    w = (rng.normal(size=(4, 24)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(24,)) * 0.1).astype(np.float32)
    jx, jw, jb = (jnp.asarray(a).astype(dtype) for a in (x, w, b))
    ref = np.asarray(JS._causal_conv(jx, jw, jb).astype(jnp.float32))
    tx, tw, tb = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
                  for a in (jx, jw, jb))
    np.testing.assert_array_equal(S.causal_conv(tx, tw, tb).float().numpy(), ref)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_no_launch():
    x, dt, A, Bm, Cm = _torch(*_inputs(1, 80, 8, 32, 4, 16, seed=2))
    before = K.ssd_scan.launches
    y = K.ssd_scan(x, dt, A, Bm, Cm, chunk=32)
    assert K.ssd_scan.launches == before
    assert torch.equal(y, K.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=32))


def test_cpu_route_differentiates_like_the_plain_function():
    """On CPU tensors the wrapper is the plain version, autograd included:
    its gradients are those of ``ssd_scan_plain``."""
    arrays = _torch(*_inputs(1, 48, 4, 16, 2, 8, seed=7))
    grads = []
    for fn in (K.ssd_scan, K.ssd_scan_plain):
        args = [t.clone().requires_grad_(True) for t in arrays]
        y = fn(*args, chunk=16)
        (y * torch.linspace(-1.0, 1.0, y.numel()).view(y.shape)).sum().backward()
        grads.append([t.grad for t in args])
    for got, want in zip(*grads):
        assert got is not None and torch.equal(got, want)


def test_wrapper_refuses_what_the_scan_does_not_take():
    x, dt, A, Bm, Cm = _torch(*_inputs(1, 32, 6, 16, 4, 8))
    with pytest.raises(ValueError, match="groups of B and C must divide"):
        K.ssd_scan(x, dt, A, Bm, Cm, chunk=16)  # 4 groups, 6 heads
    x, dt, A, Bm, Cm = _torch(*_inputs(1, 32, 4, 16, 2, 8))
    with pytest.raises(ValueError, match="share one dtype"):
        K.ssd_scan(x, dt, A, Bm.to(torch.bfloat16), Cm, chunk=16)
    with pytest.raises(ValueError, match="must be float32"):
        K.ssd_scan(x, dt.double(), A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="must be"):
        K.ssd_scan(x, dt[:, :16], A, Bm, Cm, chunk=16)
    meta = [t.to("meta") for t in (x, dt, A, Bm, Cm)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        K.ssd_scan(*meta, chunk=16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")


@pytest.mark.parametrize("needs_grad", range(5))
def test_cuda_wrapper_refuses_grad_mode_before_launching(cuda, needs_grad):
    """No backward kernel yet (ROADMAP Queue 1 item 16): with grad mode on
    and any of x, dt, A, B, C requiring grad the wrapper raises before any
    launch; under inference_mode the same call launches."""
    args = [t.cuda() for t in _torch(*_inputs(1, 64, 4, 32, 1, 16, seed=8))]
    args[needs_grad].requires_grad_(True)
    before = K.ssd_scan.launches
    with pytest.raises(RuntimeError, match="Queue 1 item 16"):
        K.ssd_scan(*args, chunk=32)
    assert K.ssd_scan.launches == before
    with torch.inference_mode():
        y = K.ssd_scan(*args, chunk=32)
    assert K.ssd_scan.launches == before + 1 and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("B,S_,H,P,G,N,chunk", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda, B, S_, H, P, G, N, chunk, dtype):
    x, dt, A, Bm, Cm = (t.cuda() for t in _torch(*_inputs(B, S_, H, P, G, N, seed=5)))
    x, Bm, Cm = x.to(dtype), Bm.to(dtype), Cm.to(dtype)
    y = K.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    ref = K.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.cpu().numpy(), ref.cpu().numpy(), atol=2e-5, rtol=2e-4)
