"""Mamba-2's causal conv1d + bias + SiLU on its kernels: ``causal_conv_silu``
and its route in ``mamba2_apply``. No JAX here, so that the card-only tests
run on the card (``python -m pytest tests/test_torch_conv_grad.py``); the
plain ``causal_conv`` is held to the reference's in ``tests/test_torch_ssd.py``.

On the CPU and the meta device:
* the CPU route is ``silu(causal_conv(...))`` under autograd, bit for bit,
  and counts no launch; ``mamba2_apply`` on the CPU convolves x|B|C as
  before, bit for bit;
* ``mamba2_apply`` takes the kernels by device, dtype, taps, width, stride
  and decode state alone;
* the meta route (the dry run) allocates y and the three gradients with
  their shapes and dtypes and charges ``causal_conv_cost`` and
  ``causal_conv_bwd_cost``, under ``vmap`` once for the folded peers;
* the ``vmap`` rules, run on the CPU with the kernel launches replaced by
  plain autograd (``plain_kernels``), give a banked step's and the plain
  mean's gradients inside a ``RecomputeGroupFn``.

On the card (``test_cuda_*``, skipped without one), against autograd of the
plain ``causal_conv`` and SiLU in f32 on the same values: y, dx, dw and db
within 1e-5 of each one's largest magnitude plus their rounding to bf16
(2^-8 of the element), at both benchmark cells' shapes on the projection's
strided view; the kernels sum in f32 and round once, so their own error is
that rounding alone.
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels import causal_conv as K
from repro_torch.kernels.cost import causal_conv_bwd_cost, causal_conv_cost
from repro_torch.models import ssm as S
from repro_torch.models.transformer import RecomputeGroupFn

torch.set_num_threads(2)  # the test workers share the CPU with each other

bf16 = torch.bfloat16


def _proj_inputs(B, S_, C, width, col, taps, *, device, seed=0, dtype=bf16):
    """x a (B, S, C) view at column ``col`` of a (B, S, width) projection, as
    ``mamba2_apply`` passes it; w (K, C), b (C,), and a cotangent dy."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    proj = torch.randn((B, S_, width), generator=g).to(dtype)
    w = (torch.randn((taps, C), generator=g) * 0.3).to(dtype)
    b = (torch.randn((C,), generator=g) * 0.1).to(dtype)
    dy = torch.randn((B, S_, C), generator=g).to(dtype)
    proj, w, b, dy = (t.to(device) for t in (proj, w, b, dy))
    return proj[..., col:col + C], w, b, dy


def _plain_f32(x, w, b, dy):
    """y and (dx, dw, db) by autograd of the plain function in f32 on the
    same values."""
    leaves = [t.detach().float().requires_grad_(True) for t in (x, w, b)]
    y = F.silu(K.causal_conv(*leaves))
    return y.detach(), torch.autograd.grad(y, leaves, dy.float())


class _Sink:
    def __init__(self):
        self.charges = []

    def charge(self, name, flops, nbytes):
        self.charges.append((name, flops, nbytes))


@pytest.fixture
def sink():
    s = _Sink()
    build.SINKS.append(s)
    yield s
    build.SINKS.remove(s)


def _counts():
    return K.causal_conv_silu.launches, K.causal_conv_silu_backward.launches


@pytest.mark.parametrize("dtype", [torch.float32, bf16])
def test_cpu_route_is_the_plain_function_under_autograd(dtype):
    x, w, b, dy = _proj_inputs(2, 37, 24, 60, 12, 4, device="cpu", seed=1, dtype=dtype)
    before = _counts()
    got = []
    for fn in (K.causal_conv_silu, lambda *a: F.silu(K.causal_conv(*a))):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        y = fn(*leaves)
        got.append((y.detach(), torch.autograd.grad(y, leaves, dy)))
    (y, grads), (y_ref, grads_ref) = got
    assert torch.equal(y, y_ref)
    for a, r in zip(grads, grads_ref):
        assert a.dtype == r.dtype and torch.equal(a, r)
    direct = K.causal_conv_silu_backward(x, w, b, dy)
    assert all(torch.equal(a, r) for a, r in zip(direct, grads_ref))
    assert _counts() == before


def test_cpu_mamba2_apply_convolves_x_B_C_as_before(monkeypatch):
    """On the CPU the block convolves the x|B|C view of the projection with
    the plain ``causal_conv``: the same bits as on their concatenation, as
    the block did before, and the route never reaches the kernels."""
    cfg = dataclasses.replace(get_config("mamba2-370m"), d_model=64, ssm_headdim=16, ssm_state=8,
                              ssm_chunk=16, dtype="bfloat16", param_dtype="float32")
    mod = S.Mamba2(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    seen = []
    plain = S.causal_conv
    monkeypatch.setattr(S, "causal_conv", lambda *a: seen.append(a) or plain(*a))
    monkeypatch.setattr(S, "causal_conv_silu", None)  # never called on the CPU
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator().manual_seed(1)).to(bf16)
    with torch.no_grad():
        S.mamba2_apply(mod, x, cfg)
    (conv_in, w, b), = seen
    di, GN = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    proj = F.linear(x, mod.in_proj.weight.to(bf16))
    z, xs, Bm, Cm, _ = torch.split(proj, [di, di, GN, GN, cfg.ssm_heads], dim=-1)
    cat = torch.cat([xs, Bm, Cm], dim=-1)
    assert torch.equal(conv_in, cat)
    assert torch.equal(plain(conv_in, w, b), plain(cat, w, b))


def _route_cfg(**kw):
    base = dict(d_model=256, ssm_headdim=64, ssm_state=128, ssm_chunk=256, dtype="bfloat16",
                param_dtype="float32")
    base.update(kw)
    return dataclasses.replace(get_config("mamba2-370m"), **base)


@pytest.mark.parametrize("device,dtype,cfg_kw,with_state,expected", [
    ("meta", "bfloat16", {}, False, "causal_conv_silu"),
    ("meta", "bfloat16", {}, True, "causal_conv"),  # prefill fills the decode state
    ("meta", "float32", {}, False, "causal_conv"),
    ("cpu", "bfloat16", {}, False, "causal_conv"),
    ("meta", "bfloat16", {"ssm_conv": 5}, False, "causal_conv"),  # more than 4 taps
    ("meta", "bfloat16", {"ssm_conv": 2}, False, "causal_conv_silu"),
    ("meta", "bfloat16", {"ssm_state": 5}, False, "causal_conv"),  # C = 522, not a multiple of 4
    # 3 heads of 64: the projection's row of 643 is off 8 bytes (8 heads: 1,288)
    ("meta", "bfloat16", {"d_model": 96}, False, "causal_conv"),
    ("meta", "bfloat16", {"d_model": 128}, False, "causal_conv_silu"),  # 4 heads: a row of 772
])
def test_mamba2_apply_routes_by_what_the_input_shows(monkeypatch, device, dtype, cfg_kw,
                                                    with_state, expected):
    cfg = _route_cfg(**cfg_kw)
    mod = S.Mamba2(cfg, generator=torch.Generator().manual_seed(0), device="cpu").to(device)
    called = []
    for name in ("causal_conv_silu", "causal_conv"):
        fn = getattr(S, name)
        monkeypatch.setattr(S, name, lambda *a, _fn=fn, _n=name: called.append(_n) or _fn(*a))
    x = torch.zeros((1, 512, cfg.d_model), dtype=getattr(torch, dtype), device=device)
    state = S.init_mamba2_state(cfg, 1, x.dtype, device=device) if with_state else None
    with torch.no_grad():
        S.mamba2_apply(mod, x, cfg, state=state)
    assert called == [expected]


def test_decode_step_takes_no_kernel(monkeypatch):
    cfg = _route_cfg()
    mod = S.Mamba2(cfg, generator=torch.Generator().manual_seed(0), device="cpu").to("meta")
    monkeypatch.setattr(S, "causal_conv_silu", None)
    monkeypatch.setattr(S, "causal_conv", None)
    state = S.init_mamba2_state(cfg, 2, bf16, device="meta")
    with torch.no_grad():
        y, new = S.mamba2_apply(mod, torch.zeros((2, 1, cfg.d_model), dtype=bf16, device="meta"),
                                cfg, state=state)
    assert y.shape == (2, 1, cfg.d_model) and new["conv"].shape == state["conv"].shape


def test_conv_takes_only_the_kernels_envelope():
    def case(B=2, S_=64, C=64, taps=4, width=None, col=0, dtype=bf16, device="meta", w_shape=None):
        proj = torch.empty((B, S_, width or C), dtype=dtype, device=device)
        x = proj[..., col:col + C]
        w = torch.empty(w_shape or (taps, C), dtype=dtype, device=device)
        return K.conv_takes(x, w, torch.empty((C,), dtype=dtype, device=device))

    assert case() and case(taps=1) and case(C=2304, width=4384, col=2048)
    assert case(C=7424, width=14704, col=7168) and case(B=1, S_=1, width=67, col=3)
    assert case(C=60) and case(width=644, col=4)
    assert not case(device="cpu") and not case(dtype=torch.float32) and not case(taps=5)
    assert not case(C=62) and not case(width=642, col=2) and not case(w_shape=(4, 32))
    x = torch.empty((2, 64, 64), dtype=bf16, device="meta").transpose(0, 1)  # batch stride 64
    assert K.conv_takes(x, torch.empty((4, 64), dtype=bf16, device="meta"),
                        torch.empty((64,), dtype=bf16, device="meta"))
    strided = torch.empty((2, 64, 128), dtype=bf16, device="meta")[..., ::2]
    assert not K.conv_takes(strided, torch.empty((4, 64), dtype=bf16, device="meta"),
                            torch.empty((64,), dtype=bf16, device="meta"))


def test_meta_route_allocates_and_charges_both_costs(sink):
    x, w, b, _ = _proj_inputs(2, 300, 2304, 4384, 2048, 4, device="meta")
    leaves = [t.requires_grad_(True) for t in (x, w, b)]
    before = _counts()
    y = K.causal_conv_silu(*leaves)
    assert (y.shape, y.dtype, y.device.type) == ((2, 300, 2304), bf16, "meta")
    grads = torch.autograd.grad(y, leaves, torch.ones_like(y))
    assert [(tuple(g.shape), g.dtype) for g in grads] == [(tuple(t.shape), bf16) for t in leaves]
    direct = K.causal_conv_silu_backward(x, w, b, y)
    assert [tuple(g.shape) for g in direct] == [(2, 300, 2304), (4, 2304), (2304,)]
    assert _counts() == before
    fwd, bwd = causal_conv_cost(x, 4), causal_conv_bwd_cost(x, 4)
    assert sink.charges == [("causal_conv_silu", *fwd), ("causal_conv_silu_backward", *bwd),
                            ("causal_conv_silu_backward", *bwd)]
    assert fwd == (0, 2 * 2 * 2 * 300 * 2304 + 2 * 5 * 2304)
    assert bwd == (0, 3 * 2 * 2 * 300 * 2304 + 2 * 2 * 5 * 2304)


def test_meta_route_folds_vmapped_peers_into_one_call(sink):
    """grad of the peers' mean loss over ``vmap`` (the cells' shape of call):
    one forward and one backward call on the folded batch, and the shared
    w and b get the sums of the peers' gradients."""
    x, w, b, _ = _proj_inputs(4, 256, 64, 96, 16, 4, device="meta")
    peers = x.detach().unflatten(0, (2, 2))

    def loss(w, b, x):
        return K.causal_conv_silu(x, w, b).float().sum()

    def mean_loss(w, b, peers):
        return torch.func.vmap(loss, in_dims=(None, None, 0))(w, b, peers).mean()

    gw, gb = torch.func.grad(mean_loss, argnums=(0, 1))(w, b, peers)
    assert (gw.shape, gb.shape) == ((4, 64), (64,))
    folded = torch.empty((4, 256, 64), dtype=bf16, device="meta")
    assert sink.charges == [("causal_conv_silu", *causal_conv_cost(folded, 4)),
                            ("causal_conv_silu_backward", *causal_conv_bwd_cost(folded, 4))]


@pytest.mark.parametrize("w_dims", [(None, None), (0, None), (None, 0), (0, 0)])
def test_meta_route_nests_vmaps_and_folds_vmapped_weights(sink, w_dims):
    """Per-sample gradients under two vmaps, w and b shared or vmapped at
    either level: one call of each kernel on the twice-folded batch, the
    weights' gradients per (outer, inner) slice."""
    x, w, b, _ = _proj_inputs(6, 128, 32, 32, 0, 3, device="meta")
    batch = x.detach().unflatten(0, (2, 3))
    if w_dims[1] == 0:
        w, b = w.expand(3, *w.shape), b.expand(3, *b.shape)
    if w_dims[0] == 0:
        w, b = w.expand(2, *w.shape), b.expand(2, *b.shape)

    def loss(w, b, x):
        return K.causal_conv_silu(x[None], w, b).float().sum()

    inner = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                            in_dims=(w_dims[1], w_dims[1], 0))
    gw, gb = torch.func.vmap(inner, in_dims=(w_dims[0], w_dims[0], 0))(w, b, batch)
    assert (gw.shape, gb.shape) == ((2, 3, 3, 32), (2, 3, 32))
    assert [name for name, *_ in sink.charges] == ["causal_conv_silu", "causal_conv_silu_backward"]


def _banked_step(conv, w, b, proj, wgt, C, col, *, banked=True, shared=False):
    """Gradients and losses of the peers' conv inside a ``RecomputeGroupFn``.
    ``banked``: as ``core/p2p.py``'s banked step takes them, ``vmap`` over
    each peer's ``grad_and_value``, every peer with its own w and b; else
    the plain mean's ``grad_and_value`` of the peers' mean loss over
    ``vmap``, w and b per peer or ``shared``. proj is each peer's."""
    positions = torch.arange(proj.shape[-2], device=proj.device)

    def run(positions, proj, params):
        w, b = params
        return conv(proj[..., col:col + C], w, b), torch.zeros((), device=proj.device)

    def loss(w, b, proj, wgt):
        y, _ = RecomputeGroupFn.apply(run, positions, proj, w, b)
        return (y.float() * wgt).sum() / 1e3

    if banked:
        step = torch.func.vmap(torch.func.grad_and_value(loss, argnums=(0, 1, 2)))
        return step(w, b, proj, wgt)

    def mean_loss(w, b, proj, wgt):
        dims = None if shared else 0
        return torch.func.vmap(loss, in_dims=(dims, dims, 0, 0))(w, b, proj, wgt).mean()

    return torch.func.grad_and_value(mean_loss, argnums=(0, 1, 2))(w, b, proj, wgt)


def _banked_plain(w, b, proj, wgt, C, col, *, banked=True, shared=False):
    """``_banked_step``'s gradients and losses by autograd of the plain
    function in f32, peer by peer, on the same values, y rounded to bf16 as
    the kernel writes it (so its cotangent too is the kernel's); and for
    each gradient the magnitude whose bf16 rounding it may carry."""
    peers = proj.shape[0]
    grads, values = [], []
    for p in range(peers):
        leaves = [t.detach().float().requires_grad_(True)
                  for t in ((w, b) if shared else (w[p], b[p])) + (proj[p],)]
        y = F.silu(K.causal_conv(leaves[2][..., col:col + C], leaves[0], leaves[1]))
        value = (y.to(bf16).float() * wgt[p]).sum() / 1e3  # y and its cotangent in bf16
        grads.append(torch.autograd.grad(value, leaves))
        values.append(value.detach())
    grads = [torch.stack(g) for g in zip(*grads)]
    if banked:
        return grads, torch.stack(values), [g.abs() for g in grads]
    dw, db = (g.sum(0) if shared else g for g in grads[:2])
    want = [dw / peers, db / peers, grads[2] / peers]
    # a shared weight's gradient is each peer's share in bf16 (the remat
    # group's vmapped backward), then their sum, also in bf16
    shares = [g.abs().sum(0) / peers + w.abs() if shared else w.abs()
              for g, w in zip(grads[:2], want[:2])]
    return want, torch.stack(values).mean(), shares + [want[2].abs()]


def _banked_inputs(peers, rows, S_, C, width, col, taps, *, device, seed, shared=False):
    """Each peer's projection, w and b (or one of each), and a loss weight."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    proj = torch.randn((peers, rows, S_, width), generator=g).to(bf16)
    n = () if shared else (peers,)
    w = (torch.randn((*n, taps, C), generator=g) * 0.3).to(bf16)
    b = (torch.randn((*n, C), generator=g) * 0.1).to(bf16)
    wgt = torch.randn((peers, rows, S_, C), generator=g)
    return [t.to(device) for t in (w, b, proj, wgt)]


def test_meta_banked_step_folds_each_peers_weights(sink):
    """A banked step on meta (each peer's w and b under ``vmap`` inside
    ``RecomputeGroupFn``): the group's forward, its recompute and the
    backward each one call on the folded peers, each gradient in its leaf's
    shape."""
    w, b, proj, wgt = _banked_inputs(2, 2, 256, 64, 160, 32, 4, device="meta", seed=0)
    (dw, db, dproj), value = _banked_step(K.causal_conv_silu, w, b, proj, wgt, 64, 32)
    assert [(tuple(g.shape), g.dtype) for g in (dw, db, dproj, value)] == [
        ((2, 4, 64), bf16), ((2, 64), bf16), (tuple(proj.shape), bf16), ((2,), torch.float32)]
    folded = torch.empty((4, 256, 64), dtype=bf16, device="meta")
    fwd, bwd = causal_conv_cost(folded, 4), causal_conv_bwd_cost(folded, 4)
    assert sorted(sink.charges) == sorted([("causal_conv_silu", *fwd)] * 2
                                          + [("causal_conv_silu_backward", *bwd)])


@pytest.fixture
def plain_kernels(monkeypatch):
    """The two launches of :class:`CausalConvFn` replaced by autograd of the
    plain function on the CPU, each batch row with its row of w and b (as
    the kernels read them), the backward's sums per group as the kernel
    writes them, so that the Functions and their ``vmap`` rules run on the
    CPU as on the card; each call counted as a launch."""
    def rows(t, stride, batch):  # the weights as ``_per_batch_row`` gives them, a row each
        return t if stride else t.expand(batch, *t.shape)

    def conv(x, w, b):
        return torch.cat([F.silu(K.causal_conv(x[i:i + 1], w[i], b[i])) for i in range(x.shape[0])])

    def forward(x, w, w_sb, b, b_sb, y):
        Bsz = x.shape[0]
        y.copy_(conv(x.float(), rows(w, w_sb, Bsz).float(), rows(b, b_sb, Bsz).float()))
        K.causal_conv_silu.launches += 1

    def backward(x, w, w_sb, b, b_sb, dy, dx, part, sums):
        Bsz = x.shape[0]
        leaves = [x.float().requires_grad_(True), rows(w, w_sb, Bsz).float().requires_grad_(True),
                  rows(b, b_sb, Bsz).float().requires_grad_(True)]
        with torch.enable_grad():
            gx, gw, gb = torch.autograd.grad(conv(*leaves), leaves, dy.float())
        dx.copy_(gx)
        n = sums.shape[0]
        sums.copy_(torch.cat([gw, gb[:, None]], dim=1).unflatten(0, (n, -1)).sum(1))
        K.causal_conv_silu_backward.launches += 1

    monkeypatch.setattr(K, "_launch_forward", forward)
    monkeypatch.setattr(K, "_launch_backward", backward)


def _hold(got, want, name, rel=1e-5, magnitude=None):
    """``got`` within ``rel`` of max|want| of the plain f32 value ``want``,
    and where ``got`` is bf16 also within its rounding (2^-8 |want|, or
    2^-8 ``magnitude`` where it was rounded in parts)."""
    rounded = got.dtype == bf16
    got = got.float()
    scale = float(want.abs().max())
    err = (got - want).abs()
    magnitude = want.abs() if magnitude is None else magnitude
    limit = rel * scale + (2.0 ** -8 * magnitude if rounded else 0.0)
    bad = err > limit
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} elements past the limit, worst {float(err.max()) / scale:.3e} "
        f"of max {scale:.3e}")


@pytest.mark.parametrize("banked,shared", [(True, False), (False, False), (False, True)])
def test_vmap_rules_fold_each_peers_weights_as_the_plain_function(plain_kernels, banked, shared):
    """:class:`CausalConvFn` and its backward's Function, their ``vmap`` rules
    folding the peers (and each peer's w and b) into one call, inside a
    ``RecomputeGroupFn``, on the CPU with ``plain_kernels`` for the
    launches: a banked step (``vmap`` over ``grad_and_value``, w and b per
    peer), and the plain mean's ``grad_and_value`` over ``vmap`` with w and
    b per peer or shared, each against autograd of the plain function peer
    by peer. Two forward calls (the group's and its recompute) and one
    backward call."""
    C, width, col = 32, 72, 24
    inputs = _banked_inputs(2, 2, 40, C, width, col, 3, device="cpu", seed=5, shared=shared)
    before = _counts()
    grads, value = _banked_step(K.CausalConvFn.apply, *inputs, C, col, banked=banked,
                                shared=shared)
    assert _counts() == (before[0] + 2, before[1] + 1)
    want, want_value, magnitudes = _banked_plain(*inputs, C, col, banked=banked, shared=shared)
    assert torch.allclose(value, want_value, rtol=1e-4, atol=1e-7)
    for g, w, m, name in zip(grads, want, magnitudes, ("dw", "db", "dproj")):
        assert g.shape == w.shape, name
        _hold(g, w, name, magnitude=m)


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")


# (B, S, C, the projection's width, x's first column, taps)
CELLS = {
    "mamba2-370m": (32, 2048, 2304, 4384, 2048, 4),  # 2 peers x 16 x 2048 folded
    "zamba2-7b": (4, 4096, 7424, 14704, 7168, 4),  # 2 peers x 2 x 4096 folded
}


def _check_against_plain(x, w, b, dy):
    y = K.causal_conv_silu(x, w, b)
    got = K.causal_conv_silu_backward(x, w, b, dy)
    want_y, want = _plain_f32(x, w, b, dy)
    torch.cuda.synchronize()
    assert y.dtype == bf16 and y.shape == x.shape and y.is_contiguous()
    _hold(y, want_y, "y")
    for g, wt, t, name in zip(got, want, (x, w, b), ("dx", "dw", "db")):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        _hold(g, wt, name)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cuda_matches_plain_at_the_cells_shapes_on_the_projection(cuda, cell):
    B, S_, C, width, col, taps = CELLS[cell]
    _check_against_plain(*_proj_inputs(B, S_, C, width, col, taps, device="cuda", seed=B + C))


@pytest.mark.parametrize("B,S_,C,width,col,taps", [
    (2, 700, 264, 264, 0, 4),  # ragged runs, contiguous x
    (3, 333, 64, 200, 136, 3),  # a partial channel tile, 3 taps
    (1, 5, 16, 24, 8, 4),  # fewer steps than taps
    (2, 1100, 512, 520, 8, 2),  # 2 taps
    (4, 64, 8, 8, 0, 1),  # one tap: no halo
    (2, 300, 36, 44, 4, 4),  # C a multiple of 4 only, x 8 bytes past a 16-byte boundary
    (2, 40, 20, 24, 1, 4),  # x's base 2 bytes off: copied
])
def test_cuda_matches_plain(cuda, B, S_, C, width, col, taps):
    _check_against_plain(*_proj_inputs(B, S_, C, width, col, taps, device="cuda", seed=S_))


def test_cuda_repeats_bit_for_bit(cuda):
    x, w, b, dy = _proj_inputs(*CELLS["mamba2-370m"], device="cuda", seed=3)
    first = (K.causal_conv_silu(x, w, b), *K.causal_conv_silu_backward(x, w, b, dy))
    second = (K.causal_conv_silu(x, w, b), *K.causal_conv_silu_backward(x, w, b, dy))
    torch.cuda.synchronize()
    for a, r in zip(first, second):
        assert torch.equal(a.view(torch.int16), r.view(torch.int16))


def test_cuda_counts_one_launch_a_call_and_no_second_derivative(cuda):
    x, w, b, _ = _proj_inputs(2, 512, 256, 320, 64, 4, device="cuda", seed=2)
    leaves = [t.requires_grad_(True) for t in (x, w, b)]
    before = _counts()
    y = K.causal_conv_silu(*leaves)
    g, = torch.autograd.grad(y.float().square().sum(), [leaves[0]], create_graph=True)
    assert _counts() == (before[0] + 1, before[1] + 1)
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad(g.float().sum(), [leaves[0]])


@pytest.mark.parametrize("banked,shared", [(True, False), (False, False), (False, True)])
def test_cuda_peers_in_a_remat_group_match_plain(cuda, banked, shared):
    """The cells' call and a banked step's, as the CPU test above, on the
    kernels: two forward launches and one backward launch for both peers."""
    C, width, col = 256, 416, 128
    inputs = _banked_inputs(2, 2, 1024, C, width, col, 4, device="cuda", seed=7, shared=shared)
    before = _counts()
    grads, value = _banked_step(K.causal_conv_silu, *inputs, C, col, banked=banked,
                                shared=shared)
    assert _counts() == (before[0] + 2, before[1] + 1)
    want, want_value, magnitudes = _banked_plain(*inputs, C, col, banked=banked, shared=shared)
    torch.cuda.synchronize()
    # a last-bit flip of y's rounding moves the weighted sum by ~1e-6 here
    assert torch.allclose(value, want_value, rtol=1e-3, atol=1e-5)
    for g, w, m, name in zip(grads, want, magnitudes, ("dw", "db", "dproj")):
        assert g.shape == w.shape, name
        _hold(g, w, name, magnitude=m)
