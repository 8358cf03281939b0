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
* The CUDA kernel's bf16 body, emulated on the CPU (``_emulate_bf16_body``:
  its three passes and four products, each f32 operand split into bf16
  hi + lo terms by ``.to(torch.bfloat16)``, products of bf16 values summed
  in f32), against ``ssd_chunked`` and the Pallas kernel on the same
  bf16-rounded inputs: atol 2e-5 + rtol 2e-4 at the small shapes, 2e-5 of
  max|y| at mamba2-370m's widths (S 2048, P 64, N 128, chunk 256, 4 heads),
  where a single bf16 term per operand misses that limit.

The CUDA kernel is held against the plain version by ``test_cuda_*``
(which skip without a card) and by ``chip_smoke.py``.
"""
import functools

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


def _bf16_rounded(x, dt, A, Bm, Cm):
    """The inputs with x, B and C rounded to bf16 (kept as f32 values)."""
    rnd = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    return rnd(x), dt, A, rnd(Bm), rnd(Cm)


def _split(v, terms):
    """v as the sum of ``terms`` bf16 values: hi = bf16(v), lo = bf16(v - hi), ..."""
    parts = []
    for _ in range(terms):
        part = v.to(torch.bfloat16).float()
        parts.append(part)
        v = v - part
    return parts


def _emulate_bf16_body(x, dt, A, Bm, Cm, chunk, terms=2):
    """The kernel's bf16 body in f32 on the CPU. Pass 1: each chunk's end
    state s_c = x^T W, W_j = dt_j exp(cum_last - cum_j) B_j, and its decay
    exp(cum_last); pass 2: R_0 = 0, R_{c+1} = R_c decay_c + s_c; pass 3: y =
    (C B^T o L o dt_j) x + (C R_c^T) o exp(cum_i). x, B and C hold bf16
    values; W, S' = C B^T o L o dt_j and R_c enter their products as
    ``terms`` bf16 terms each. Returns y (B, S, H, P)."""
    Bsz, S_, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S_ // chunk)
    pad = nc * chunk - S_
    padded = lambda a: np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
    xt, dtt, Bt, Ct = (torch.from_numpy(padded(a)).float() for a in (x, dt, Bm, Cm))
    At = torch.from_numpy(A).float()
    heads = torch.arange(H) // (H // G)
    xc = xt.reshape(Bsz, nc, chunk, H, P)
    dtc = dtt.reshape(Bsz, nc, chunk, H)
    Bc = Bt.reshape(Bsz, nc, chunk, G, N)[:, :, :, heads]  # (B, nc, Q, H, N)
    Cc = Ct.reshape(Bsz, nc, chunk, G, N)[:, :, :, heads]
    cum = torch.cumsum(dtc * At, dim=2)
    # pass 1: s_c (B, nc, H, P, N) and the decays (B, nc, H)
    W = Bc * (dtc * torch.exp(cum[:, :, -1:] - cum))[..., None]
    states = sum(torch.einsum("bcqhp,bcqhn->bchpn", xc, w) for w in _split(W, terms))
    decay = torch.exp(cum[:, :, -1])
    # pass 2: the entering states
    R = torch.zeros((Bsz, H, P, N))
    entering = []
    for c in range(nc):
        entering.append(R)
        R = R * decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)
    # pass 3
    ii = torch.arange(chunk)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, i, j, H)
    L = torch.exp(torch.where(causal, diff, float("-inf")))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * L * dtc[:, :, None, :, :]
    y = sum(torch.einsum("bcijh,bcjhp->bcihp", sp, xc) for sp in _split(scores, terms))
    y_off = sum(torch.einsum("bcihn,bchpn->bcihp", Cc, r) for r in _split(entering, terms))
    y = y + y_off * torch.exp(cum)[..., None]
    return y.reshape(Bsz, nc * chunk, H, P)[:, :S_].numpy()


def _terms_product(eq, a, b, terms, a_exact=False, b_exact=False):
    """einsum(eq, a, b) with each f32 operand as ``terms`` bf16 terms and the
    products of term pairs (u, v) with u + v < terms summed in f32: with two
    terms hi hi + hi lo + lo hi where both are f32, hi + lo where one is
    exact in bf16."""
    sa = [a] if a_exact else _split(a, terms)
    sb = [b] if b_exact else _split(b, terms)
    return sum(torch.einsum(eq, pa, pb) for u, pa in enumerate(sa) for v, pb in enumerate(sb)
               if u + v < terms)


def _emulate_bf16_backward(x, dt, A, Bm, Cm, dy, chunk, terms=2):
    """The backward kernel's passes (csrc/ssd_scan_bwd.cu) in f32 on the CPU,
    every product of the kernel as ``_terms_product`` of its operands: x, B
    and C exact, dy, e o dy, M, dS and the states R_c and ds_c in ``terms``
    bf16 terms. The entering states come from the forward's passes 1-2 as
    its saved hi and lo halves. Returns (dx, ddt, dA, dB, dC) as numpy f32."""
    Bsz, S_, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S_ // chunk)
    pad = nc * chunk - S_
    padded = lambda a: np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
    xt, dtt, Bt, Ct, dyt = (torch.from_numpy(padded(a)).float() for a in (x, dt, Bm, Cm, dy))
    At = torch.from_numpy(A).float()
    heads = torch.arange(H) // (H // G)
    xc = xt.reshape(Bsz, nc, chunk, H, P)
    dtc = dtt.reshape(Bsz, nc, chunk, H)
    dyc = dyt.reshape(Bsz, nc, chunk, H, P)
    Bc = Bt.reshape(Bsz, nc, chunk, G, N)[:, :, :, heads]  # (B, nc, Q, H, N)
    Cc = Ct.reshape(Bsz, nc, chunk, G, N)[:, :, :, heads]
    cum = torch.cumsum(dtc * At, dim=2)
    e, w, D = torch.exp(cum), torch.exp(cum[:, :, -1:] - cum), torch.exp(cum[:, :, -1])
    # the forward's entering states R_c, saved as terms
    states = _terms_product("bcqhp,bcqhn->bchpn", xc, Bc * (dtc * w)[..., None], terms,
                            a_exact=True)
    R, entering = torch.zeros((Bsz, H, P, N)), []
    for c in range(nc):
        entering.append(R)
        R = R * D[:, c, :, None, None] + states[:, c]
    R = sum(_split(torch.stack(entering, dim=1), terms))
    # 1. direct: (e dy)^T C
    direct = _terms_product("bcqhp,bcqhn->bchpn", e[..., None] * dyc, Cc, terms, b_exact=True)
    # 2. carry: ds_c = dR_{c+1}; the chunk end gets D_c sum(ds_c o R_c)
    G_, ds, dcumQ = torch.zeros((Bsz, H, P, N)), torch.zeros_like(R), torch.zeros((Bsz, nc, H))
    for c in reversed(range(nc)):
        ds[:, c] = G_
        dcumQ[:, c] = (G_ * R[:, c]).sum((-1, -2)) * D[:, c]
        G_ = G_ * D[:, c, :, None, None] + direct[:, c]
    ds = sum(_split(ds, terms))
    # 3. rows: dC = e (dy R), dcum = C . dC; S, dM = dt_j (dy_i . x_j), dC += dS B
    dC = _terms_product("bcqhp,bchpn->bcqhn", dyc, R, terms) * e[..., None]
    dcum = (Cc * dC).sum(-1)
    ii = torch.arange(chunk)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    L = torch.exp(torch.where(causal, cum[:, :, :, None, :] - cum[:, :, None, :, :],
                              float("-inf")))  # (B, nc, i, j, H)
    M = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * L
    dM = _terms_product("bcihp,bcjhp->bcijh", dyc, xc, terms, b_exact=True)
    dM = dM * dtc[:, :, None, :, :] * causal
    Z = dM * M
    dS = dM * L
    dC = dC + _terms_product("bcijh,bcjhn->bcihn", dS, Bc, terms, b_exact=True)
    dcum = dcum + Z.sum(3)
    # 4. cols: the state terms T = x ds, B ds^T; dxdt += M^T dy, dB += dS^T C
    T = _terms_product("bcjhp,bchpn->bcjhn", xc, ds, 1, a_exact=True, b_exact=True)
    wdw = w * dtc * (Bc * T).sum(-1)
    dxdt = w[..., None] * _terms_product("bcjhn,bchpn->bcjhp", Bc, ds, 1, a_exact=True,
                                         b_exact=True)
    dB = (w * dtc)[..., None] * T
    dcum = dcum - wdw
    dcumQ = dcumQ + wdw.sum(2)
    dxdt = dxdt + _terms_product("bcijh,bcihp->bcjhp", M, dyc, terms)
    dB = dB + _terms_product("bcijh,bcihn->bcjhn", dS, Cc, terms, b_exact=True)
    dcum = dcum - Z.sum(2)
    # 5. finish: the reverse cumsum within the chunk
    dcum[:, :, -1] += dcumQ
    da = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    ddt = (xc * dxdt).sum(-1) + da * At
    dA = (da * dtc).sum((0, 1, 2))
    # 6. heads to groups
    to_groups = lambda t: t.reshape(Bsz, nc, chunk, G, H // G, N).sum(4)
    cut = lambda t: t.reshape(Bsz, nc * chunk, *t.shape[3:])[:, :S_].numpy()
    return (cut(dxdt * dtc[..., None]), cut(ddt), dA.numpy(), cut(to_groups(dB)),
            cut(to_groups(dC)))


def _ssd_grads_autograd(arrays, dy, chunk):
    """Autograd of the port's ``ssd_chunked``'s y in f32 at ``dy``."""
    leaves = [t.requires_grad_(True) for t in _torch(*arrays)]
    y = K.ssd_chunked(*leaves, chunk)[0]
    return [g.numpy() for g in torch.autograd.grad(y, leaves, torch.from_numpy(dy))]


def _ssd_grads_jax(arrays, dy, chunk):
    """jax.grad of the reference's ``models/ssm.py:ssd_chunked``'s y at ``dy``."""
    f = lambda *a: jnp.sum(JS.ssd_chunked(*a, chunk)[0] * jnp.asarray(dy))
    return [np.asarray(g) for g in jax.grad(f, argnums=range(5))(*map(jnp.asarray, arrays))]


def _grad_case(B, S_, H, P, G, N, seed):
    """bf16-rounded x, B, C, f32 dt, A and a cotangent dy."""
    arrays = _bf16_rounded(*_inputs(B, S_, H, P, G, N, seed=seed))
    dy = np.random.default_rng(seed + 1).normal(size=(B, S_, H, P)).astype(np.float32)
    return arrays, dy


def _worst_gaps(got, want):
    """Each gradient's largest gap over its reference's largest magnitude."""
    return [float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want)]


@functools.lru_cache(maxsize=None)
def _mamba2_width_case():
    """One (batch, head group) of mamba2-370m's scoring widths, chip_smoke's
    input distribution: x, dt, A, B, C (x, B, C bf16-rounded) and the f32
    reference y of ``ssd_chunked`` on them."""
    arrays = _bf16_rounded(*_inputs(1, 2048, 4, 64, 1, 128, seed=21))
    y_ref = K.ssd_chunked(*_torch(*arrays), 256)[0].numpy()
    return arrays, y_ref


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


@pytest.mark.parametrize("B,S_,H,P,G,N,chunk", SHAPES)
def test_bf16_body_emulation_matches_chunked_and_pallas(B, S_, H, P, G, N, chunk):
    """The split premise at the kernel tests' shapes: the bf16 body with hi +
    lo terms within the Pallas-vs-oracle tolerance of ``ssd_chunked`` and of
    the Pallas kernel on the same bf16-rounded inputs."""
    arrays = _bf16_rounded(*_inputs(B, S_, H, P, G, N, seed=S_ + H + N))
    y = _emulate_bf16_body(*arrays, chunk)
    y_chunked = K.ssd_chunked(*_torch(*arrays), chunk)[0].numpy()
    y_pallas = np.asarray(ssd_scan_pallas(*map(jnp.asarray, arrays), chunk=chunk))
    assert y.shape == (B, S_, H, P)
    np.testing.assert_allclose(y, y_chunked, atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(y, y_pallas, atol=2e-5, rtol=2e-4)


def test_bf16_body_emulation_holds_at_mamba2_widths():
    """At one head group of mamba2-370m's scoring widths the hi + lo body is
    within 2e-5 of max|y| of ``ssd_chunked`` (the limit ``chip_smoke.py``
    holds the card to)."""
    arrays, y_ref = _mamba2_width_case()
    err = np.abs(_emulate_bf16_body(*arrays, 256) - y_ref).max()
    assert err <= 2e-5 * np.abs(y_ref).max()


def test_single_bf16_term_misses_the_limit_at_mamba2_widths():
    """The split is needed: with one bf16 term per f32 operand the same
    case lands outside 2e-5 of max|y|."""
    arrays, y_ref = _mamba2_width_case()
    err = np.abs(_emulate_bf16_body(*arrays, 256, terms=1) - y_ref).max()
    assert err > 2e-5 * np.abs(y_ref).max()


GRAD_SHAPES = SHAPES + [(2, 700, 8, 64, 2, 128, 256)]  # groups and a ragged last chunk


@pytest.mark.parametrize("B,S_,H,P,G,N,chunk", GRAD_SHAPES)
def test_bf16_backward_emulation_matches_autograd_and_jax_grad(B, S_, H, P, G, N, chunk):
    """The backward kernel's algorithm, hi + lo products summed in f32, holds
    every gradient within 5e-5 of its largest magnitude of autograd through
    the port's ``ssd_chunked`` and of ``jax.grad`` of the reference's, on the
    same bf16-rounded inputs: the split leaves about 2^-16 of each product
    term (measured 1e-6 to 1.1e-5 of the largest magnitude here), and f32
    sums in another order a few ulps more; the two f32 references, which
    sum in different orders too, agree within 1e-5 (6.3e-6 measured, dA at
    the largest shape)."""
    arrays, dy = _grad_case(B, S_, H, P, G, N, seed=S_ + N)
    got = _emulate_bf16_backward(*arrays, dy, chunk)
    torch_grads = _ssd_grads_autograd(arrays, dy, chunk)
    jax_grads = _ssd_grads_jax(arrays, dy, chunk)
    for g, t, j in zip(got, torch_grads, jax_grads):
        assert g.shape == t.shape == j.shape
    assert max(_worst_gaps(torch_grads, jax_grads)) <= 1e-5
    assert max(_worst_gaps(got, torch_grads)) <= 5e-5
    assert max(_worst_gaps(got, jax_grads)) <= 5e-5


@functools.lru_cache(maxsize=None)
def _mamba2_grad_case():
    """One (batch, head group) of mamba2-370m's training widths (S 2048, P
    64, N 128, chunk 256, 4 heads): inputs, dy and autograd's gradients."""
    arrays, dy = _grad_case(1, 2048, 4, 64, 1, 128, seed=31)
    return arrays, dy, _ssd_grads_autograd(arrays, dy, 256)


def test_bf16_backward_emulation_holds_at_mamba2_widths():
    """Each gradient within 5e-5 of its largest magnitude (the card tests'
    limit for the backward kernel, ``tests/test_torch_ssd_grad.py``)."""
    arrays, dy, want = _mamba2_grad_case()
    assert max(_worst_gaps(_emulate_bf16_backward(*arrays, dy, 256), want)) <= 5e-5


def test_single_bf16_term_misses_the_backward_limit_at_mamba2_widths():
    """The split is needed: one bf16 term per f32 operand puts every
    gradient past 5e-5 of its largest magnitude (about 1e-3 to 3e-3)."""
    arrays, dy, want = _mamba2_grad_case()
    assert min(_worst_gaps(_emulate_bf16_backward(*arrays, dy, 256, terms=1), want)) > 5e-5


def test_bf16_body_refuses_the_shapes_it_does_not_take():
    """Before any launch, the bf16 body raises for a headdim or state off
    a multiple of 8 or too wide, a chunk it does not tile, or a row that is
    not 16-byte aligned; f32 inputs keep the f32 body's rules."""
    x, dt, A, Bm, Cm = (t.to(torch.bfloat16) if t.dim() == 4 else t
                        for t in _torch(*_inputs(1, 64, 2, 64, 1, 16)))
    K._check_launchable(x, Bm, Cm, 64)
    for chunk in (8, 48, 128, 256):
        K._check_launchable(x, Bm, Cm, chunk)
    for chunk in (12, 100, 320):
        with pytest.raises(ValueError, match="bf16 body"):
            K._check_launchable(x, Bm, Cm, chunk)
    for P, N in ((72, 16), (60, 16), (64, 12), (64, 136)):
        xx = torch.zeros((1, 64, 2, P), dtype=torch.bfloat16)
        bb = torch.zeros((1, 64, 1, N), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="bf16 body"):
            K._check_launchable(xx, bb, bb, 64)
    wide = torch.zeros((1, 64, 2, 65), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte rows"):
        K._check_launchable(wide[..., 1:], Bm, Cm, 64)  # a 2-byte offset, 130-byte rows
    K._check_launchable(x.float(), Bm.float(), Cm.float(), 1024)  # the f32 body's limit


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
    # meta tensors (the dry run) take the CUDA route: its checks, no launch
    meta = [t.to("meta") for t in (x, dt, A, Bm, Cm)]
    launches = K.ssd_scan.launches
    y = K.ssd_scan(*meta, chunk=16)
    assert (y.shape, y.dtype, K.ssd_scan.launches) == (x.shape, torch.float32, launches)
    with pytest.raises(ValueError, match="multiples of 4"):
        K.ssd_scan(*meta, chunk=18)


def test_reference_pallas_scan_has_no_gradient():
    """Reference behaviour 18 (ROADMAP): ``jax.grad`` through the reference's
    ``kernels.ops.ssd_scan`` (the Pallas scan, here in interpret mode) fails
    in Pallas's JVP rule, so the reference trains Mamba-2 through
    ``ssd_chunked`` (its ``lm_loss`` defaults to ``use_ssd_kernel=False``),
    and the port's scan kernel has no backward either; its CPU route
    differentiates (``test_cpu_route_differentiates_like_the_plain_function``)."""
    from repro.kernels import ops

    x, dt, A, Bm, Cm = (jnp.asarray(a) for a in _inputs(1, 16, 2, 8, 1, 8, seed=9))
    with pytest.raises(AssertionError):
        jax.grad(lambda x: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=8)[0].sum())(x)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")


@pytest.mark.parametrize("needs_grad", range(5))
def test_cuda_wrapper_refuses_grad_mode_before_launching(cuda, needs_grad):
    """No backward kernel, as the reference's Pallas scan has no gradient
    (ROADMAP reference behaviour 18): with grad mode on and any of x, dt,
    A, B, C requiring grad the wrapper raises before any launch; under
    inference_mode the same call launches."""
    args = [t.cuda() for t in _torch(*_inputs(1, 64, 4, 32, 1, 16, seed=8))]
    args[needs_grad].requires_grad_(True)
    before = K.ssd_scan.launches
    with pytest.raises(RuntimeError, match="reference behaviour 18"):
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


def test_cuda_bf16_body_on_the_models_strided_views(cuda):
    """bf16 at mamba2-370m's scoring widths on views shaped like the model's
    slices of the convolution output (seq stride 2304, x at element 0, B at
    2048, C at 2176): within 2e-5 of max|y| of the plain version."""
    g = torch.Generator(device="cuda").manual_seed(9)
    conv = (torch.randn((4, 2048, 2304), generator=g, device="cuda") * 0.4).to(torch.bfloat16)
    x = conv[..., :2048].unflatten(-1, (32, 64))
    Bm = conv[..., 2048:2176].unflatten(-1, (1, 128))
    Cm = conv[..., 2176:].unflatten(-1, (1, 128))
    dt = torch.nn.functional.softplus(torch.randn((4, 2048, 32), generator=g, device="cuda")) * 0.2
    A = -torch.exp(torch.randn((32,), generator=g, device="cuda") * 0.3)
    with torch.inference_mode():
        y = K.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
        ref = K.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=256)
    torch.cuda.synchronize()
    assert float((y - ref).abs().max()) <= 2e-5 * float(ref.abs().max())


def test_cuda_bf16_body_ragged_last_chunk_with_groups(cuda):
    """bf16 with 2 groups of 4 heads and a last chunk of 188 of 256 rows:
    every element within atol 2e-5 + rtol 2e-4 of the plain version."""
    x, dt, A, Bm, Cm = (t.cuda() for t in _torch(*_inputs(2, 700, 8, 64, 2, 128, seed=6)))
    x, Bm, Cm = x.to(torch.bfloat16), Bm.to(torch.bfloat16), Cm.to(torch.bfloat16)
    y = K.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    ref = K.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=256)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.cpu().numpy(), ref.cpu().numpy(), atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_wrapper_counts_one_launch_per_call(cuda, dtype):
    """One count per wrapper call, whichever body runs (the bf16 body's call
    is three launches)."""
    x, dt, A, Bm, Cm = (t.cuda() for t in _torch(*_inputs(1, 512, 4, 64, 1, 128, seed=4)))
    x, Bm, Cm = x.to(dtype), Bm.to(dtype), Cm.to(dtype)
    before = K.ssd_scan.launches
    for _ in range(3):
        K.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    torch.cuda.synchronize()
    assert K.ssd_scan.launches == before + 3
