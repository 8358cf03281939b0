"""The training route of the SSD scan: ``ssd_chunked_grad`` and its route in
``mamba2_apply``. No JAX here, so that the card-only tests run on the card
(``python -m pytest tests/test_torch_ssd_grad.py``); the backward's algorithm
is held to ``jax.grad`` of the reference in ``tests/test_torch_ssd.py``.

On the CPU and the meta device:
* the CPU route is ``ssd_chunked`` under autograd (the same gradients, bit
  for bit) and counts no launch;
* the meta route (the dry run) allocates y, the saved entering states and
  the five gradients with their shapes and dtypes, and charges
  ``ssd_scan_cost`` and ``ssd_scan_bwd_cost``, under ``vmap`` once for the
  folded peers, and each peer's A (a banked step's) folded with them;
* the ``vmap`` rules, run on the CPU with the kernel calls replaced by
  plain autograd (``plain_kernels``), give a banked step's and the plain
  mean's gradients inside a ``RecomputeGroupFn``;
* ``mamba2_apply`` takes the route by device, dtype, widths, chunk and
  decode state alone;
* ``ssd_scan`` still refuses grad mode (reference behaviour 18).

On the card (``test_cuda_*``, skipped without one), against autograd of the
plain ``ssd_chunked`` on the same values, x, B and C as f32 leaves (its
gradients before their rounding to bf16): every gradient within 5e-5 of its
largest magnitude, and dx, dB and dC, which the kernel writes in their
inputs' bf16, within that plus their rounding (half a bf16 ulp, at most
2^-8 of the element). The backward kernel's own error is about 1e-5 of the
largest magnitude (the CPU emulation of its hi + lo products,
``tests/test_torch_ssd.py``).
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels import ssd_scan as K
from repro_torch.kernels.cost import ssd_scan_bwd_cost, ssd_scan_cost
from repro_torch.models import ssm as S
from repro_torch.models.transformer import RecomputeGroupFn

torch.set_num_threads(2)  # the test workers share the CPU with each other

GRADS = ("dx", "ddt", "dA", "dB", "dC")


def _leaves(B, S_, H, P, G, N, *, device, seed=0, dtype=torch.bfloat16):
    """The model's layout: x, B and C slices of one conv output (B, S, H P +
    2 G N); dt after softplus; A negative. Returns (leaves, (x, dt, A, B, C))."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    conv = (torch.randn((B, S_, H * P + 2 * G * N), generator=g) * 0.5).to(dtype).to(device)
    dt_raw = torch.randn((B, S_, H), generator=g).to(device)
    A_log = (torch.randn((H,), generator=g) * 0.3).to(device)
    leaves = [t.requires_grad_(True) for t in (conv, dt_raw, A_log)]
    return leaves, _views(*leaves, H, P, G, N)


def _views(conv, dt_raw, A_log, H, P, G, N):
    x = conv[..., :H * P].unflatten(-1, (H, P))
    Bm = conv[..., H * P:H * P + G * N].unflatten(-1, (G, N))
    Cm = conv[..., H * P + G * N:].unflatten(-1, (G, N))
    return x, torch.nn.functional.softplus(dt_raw) * 0.2, -torch.exp(A_log), Bm, Cm


def _inputs_and_dy(B, S_, H, P, G, N, *, device, seed=0):
    """Plain leaf tensors x, dt, A, B, C (x, B, C bf16) and a cotangent dy."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn((B, S_, H, P), generator=g) * 0.5).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.randn((B, S_, H), generator=g)) * 0.2
    A = -torch.exp(torch.randn((H,), generator=g) * 0.3)
    Bm = (torch.randn((B, S_, G, N), generator=g) * 0.3).to(torch.bfloat16)
    Cm = (torch.randn((B, S_, G, N), generator=g) * 0.3).to(torch.bfloat16)
    dy = torch.randn((B, S_, H, P), generator=g)
    return [t.to(device) for t in (x, dt, A, Bm, Cm)], dy.to(device)


def _plain_grads(x, dt, A, Bm, Cm, dy, chunk):
    """Autograd of the plain ``ssd_chunked`` with x, B and C as f32 leaves
    of the same values: its f32 arithmetic, its gradients before any
    rounding to bf16."""
    leaves = [t.detach().float().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    y = K.ssd_chunked(*leaves, chunk)[0]
    return torch.autograd.grad(y, leaves, dy)


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


def test_cpu_route_is_the_plain_function_under_autograd():
    (x, dt, A, Bm, Cm), dy = _inputs_and_dy(2, 96, 4, 32, 2, 16, device="cpu", seed=3)
    before = (K.ssd_chunked_grad.launches, K.ssd_chunked_grad_backward.launches)
    got = []
    for fn in (K.ssd_chunked_grad, lambda *a: K.ssd_chunked(*a)[0]):
        leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        y = fn(*leaves, 32)
        got.append((y.detach(), torch.autograd.grad(y, leaves, dy)))
    (y, grads), (y_ref, grads_ref) = got
    assert torch.equal(y, y_ref)
    for a, b in zip(grads, grads_ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(K.ssd_chunked_grad_backward(x, dt, A, Bm, Cm, dy, 32)[4], grads_ref[4])
    assert (K.ssd_chunked_grad.launches, K.ssd_chunked_grad_backward.launches) == before


def test_meta_route_allocates_and_charges_both_costs(sink):
    B, S_, H, P, G, N, chunk = 2, 700, 8, 64, 2, 128, 256
    leaves, (x, dt, A, Bm, Cm) = _leaves(B, S_, H, P, G, N, device="meta")
    before = (K.ssd_chunked_grad.launches, K.ssd_chunked_grad_backward.launches)
    y, split = K.SsdChunkedFn.apply(x, dt, A, Bm, Cm, chunk)
    assert (y.shape, y.dtype, y.device.type) == ((B, S_, H, P), torch.float32, "meta")
    assert (split.shape, split.dtype) == ((B, 3, H, 2, P, N), torch.bfloat16)
    grads = torch.autograd.grad(y, leaves, torch.ones_like(y))
    assert [tuple(g.shape) for g in grads] == [tuple(t.shape) for t in leaves]
    assert [g.dtype for g in grads] == [t.dtype for t in leaves]
    direct = K.ssd_chunked_grad_backward(x, dt, A, Bm, Cm, y, chunk)
    assert [(tuple(g.shape), g.dtype) for g in direct] == [
        ((B, S_, H, P), torch.bfloat16), ((B, S_, H), torch.float32), ((H,), torch.float32),
        ((B, S_, G, N), torch.bfloat16), ((B, S_, G, N), torch.bfloat16)]
    assert (K.ssd_chunked_grad.launches, K.ssd_chunked_grad_backward.launches) == before
    fwd, bwd = ssd_scan_cost(x, Bm), ssd_scan_bwd_cost(x, Bm, chunk)
    assert sink.charges == [("ssd_chunked_grad", *fwd), ("ssd_chunked_grad_backward", *bwd),
                            ("ssd_chunked_grad", *fwd), ("ssd_chunked_grad_backward", *bwd)]
    assert bwd[0] == 2 * fwd[0]


def test_meta_route_folds_vmapped_peers_into_one_call(sink):
    """grad of the peers' mean loss over ``vmap`` (the cell's shape of call):
    one forward and one backward call on the folded batch, and the shared A
    gets the sum of the peers' gradients."""
    H, P, G, N = 4, 64, 1, 128
    _, (x, dt, A, Bm, Cm) = _leaves(4, 512, H, P, G, N, device="meta")
    peers = [t.detach().unflatten(0, (2, 2)) for t in (x, dt, Bm, Cm)]

    def loss(A, x, dt, Bm, Cm):
        return K.ssd_chunked_grad(x, dt, A, Bm, Cm, 256).sum()

    def mean_loss(A, *batch):
        return torch.func.vmap(loss, in_dims=(None, 0, 0, 0, 0))(A, *batch).mean()

    gA, _ = torch.func.grad_and_value(mean_loss)(A.detach(), *peers)
    assert gA.shape == (H,)
    folded = torch.empty((4, 512, H, P), dtype=torch.bfloat16, device="meta")
    Bf = torch.empty((4, 512, G, N), dtype=torch.bfloat16, device="meta")
    assert sink.charges == [("ssd_chunked_grad", *ssd_scan_cost(folded, Bf)),
                            ("ssd_chunked_grad_backward", *ssd_scan_bwd_cost(folded, Bf, 256))]


@pytest.mark.parametrize("a_dims", [(None, None), (0, None), (None, 0), (0, 0)])
def test_meta_route_nests_vmaps_and_folds_a_vmapped_A(sink, a_dims):
    """Per-sample gradients under two vmaps, A shared or vmapped at either
    level: one call of each kernel on the twice-folded batch, dA per
    (outer, inner) slice."""
    H, P, G, N = 4, 64, 1, 128
    _, (x, dt, A, Bm, Cm) = _leaves(6, 256, H, P, G, N, device="meta")
    batch = [t.detach().unflatten(0, (2, 3)) for t in (x, dt, Bm, Cm)]
    A = A.detach()
    if a_dims[1] == 0:
        A = A.expand(3, H)
    if a_dims[0] == 0:
        A = A.expand(2, *A.shape)

    def loss(A, x, dt, Bm, Cm):
        return K.ssd_chunked_grad(x[None], dt[None], A, Bm[None], Cm[None], 256).sum()

    per_sample = torch.func.vmap(torch.func.vmap(torch.func.grad(loss), in_dims=(a_dims[1], 0, 0, 0, 0)),
                                 in_dims=(a_dims[0], 0, 0, 0, 0))
    assert per_sample(A, *batch).shape == (2, 3, H)
    assert [name for name, *_ in sink.charges] == ["ssd_chunked_grad", "ssd_chunked_grad_backward"]


def _banked_step(ssd, A_log, conv, dt_raw, wgt, H, P, G, N, chunk, *, banked=True, shared_A=False):
    """Gradients and losses of the peers' SSD inside a ``RecomputeGroupFn``.
    ``banked``: as ``core/p2p.py``'s banked step takes them, ``vmap`` over
    each peer's ``grad_and_value``, every peer with its own A_log; else the
    plain mean's ``grad_and_value`` of the peers' mean loss over ``vmap``,
    A_log per peer or ``shared_A``. dt_raw and conv are each peer's. y stays
    in f32: a rounding to bf16 would flip the last bit of ~0.1 % of its
    elements between two versions 1e-6 apart, and their weighted sum by
    more than the versions' own difference."""
    positions = torch.arange(conv.shape[-2], device=conv.device)

    def run(positions, conv, params):
        dt_raw, A_log = params
        y = ssd(*_views(conv, dt_raw, A_log, H, P, G, N), chunk)
        return y, torch.zeros((), device=conv.device)

    def loss(A_log, conv, dt_raw, wgt):
        y, _ = RecomputeGroupFn.apply(run, positions, conv, dt_raw, A_log)
        return (y.float().flatten(-2) * wgt).sum() / 1e3

    if banked:
        step = torch.func.vmap(torch.func.grad_and_value(loss, argnums=(0, 1, 2)),
                               in_dims=(0, 0, 0, 0))
        return step(A_log, conv, dt_raw, wgt)

    def mean_loss(A_log, conv, dt_raw, wgt):
        return torch.func.vmap(loss, in_dims=(None if shared_A else 0, 0, 0, 0))(
            A_log, conv, dt_raw, wgt).mean()

    return torch.func.grad_and_value(mean_loss, argnums=(0, 1, 2))(A_log, conv, dt_raw, wgt)


def _banked_plain(A_log, conv, dt_raw, wgt, H, P, G, N, chunk, *, banked=True, shared_A=False):
    """``_banked_step``'s gradients and losses by autograd of the plain
    ``ssd_chunked``, peer by peer, conv as f32 leaves of the same values."""
    peers = conv.shape[0]
    grads, values = [], []
    for p in range(peers):
        a_log = A_log if shared_A else A_log[p]
        leaves = [a_log.detach().clone().requires_grad_(True),
                  conv[p].detach().float().requires_grad_(True),
                  dt_raw[p].detach().clone().requires_grad_(True)]
        views = _views(leaves[1], leaves[2], leaves[0], H, P, G, N)
        y = K.ssd_chunked(*views, chunk)[0]
        value = (y.flatten(-2) * wgt[p]).sum() / 1e3
        grads.append(torch.autograd.grad(value, leaves))
        values.append(value.detach())
    grads = [torch.stack(g) for g in zip(*grads)]
    if banked:
        return grads, torch.stack(values)
    dA = grads[0].sum(0) if shared_A else grads[0]
    return [dA / peers, grads[1] / peers, grads[2] / peers], torch.stack(values).mean()


def _banked_inputs(peers, rows, S_, H, P, G, N, *, device, seed, shared_A=False):
    """Each peer's conv output, dt_raw and A_log (or one A_log), and a loss weight."""
    (conv, dt_raw, A_log), _ = _leaves(peers * rows, S_, H, P, G, N, device="cpu", seed=seed)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    if not shared_A:
        A_log = A_log.detach() + torch.randn((peers, H), generator=g) * 0.3  # each peer's own
    wgt = torch.randn((peers, rows, S_, H * P), generator=g)
    conv, dt_raw = (t.detach().unflatten(0, (peers, rows)) for t in (conv, dt_raw))
    return [t.detach().to(device) for t in (A_log, conv, dt_raw, wgt)]


def test_meta_banked_step_folds_each_peers_A(sink):
    """A banked step on meta (each peer's A_log under ``vmap`` inside
    ``RecomputeGroupFn``): the group's forward, its recompute and the
    backward each one call on the folded peers, and each gradient in its
    leaf's shape."""
    H, P, G, N = 4, 64, 1, 128
    A_log, conv, dt_raw, wgt = _banked_inputs(2, 2, 512, H, P, G, N, device="meta", seed=6)
    (dA_log, dconv, ddt_raw), value = _banked_step(K.ssd_chunked_grad, A_log, conv, dt_raw, wgt,
                                                    H, P, G, N, 256)
    assert [(tuple(g.shape), g.dtype) for g in (dA_log, dconv, ddt_raw, value)] == [
        ((2, H), torch.float32), (tuple(conv.shape), torch.bfloat16),
        (tuple(dt_raw.shape), torch.float32), ((2,), torch.float32)]
    folded = torch.empty((4, 512, H, P), dtype=torch.bfloat16, device="meta")
    Bf = torch.empty((4, 512, G, N), dtype=torch.bfloat16, device="meta")
    fwd, bwd = ssd_scan_cost(folded, Bf), ssd_scan_bwd_cost(folded, Bf, 256)
    assert sorted(sink.charges) == sorted([("ssd_chunked_grad", *fwd)] * 2
                                          + [("ssd_chunked_grad_backward", *bwd)])


@pytest.fixture
def plain_kernels(monkeypatch):
    """The two kernel calls of :class:`SsdChunkedFn` replaced by autograd of
    the plain ``ssd_chunked`` on the CPU, each batch row with its row of A
    (``_A_rows``) and the gradients in the shapes ``_grad_backward`` returns,
    so that the Functions and their ``vmap`` rules run on the CPU as on the
    card; each call counted as a launch."""
    def rows_of(A, batch):
        A, stride = K._A_rows(A, batch)
        return A if stride else A.expand(batch, -1)

    def scan(x, dt, A, Bm, Cm, chunk):
        A = rows_of(A, x.shape[0])
        return torch.cat([K.ssd_chunked(x[b:b + 1], dt[b:b + 1], A[b], Bm[b:b + 1], Cm[b:b + 1],
                                        chunk)[0] for b in range(x.shape[0])])

    def forward(x, dt, A, Bm, Cm, chunk):
        K._check(x, dt, A, Bm, Cm, chunk, rows_of_A=True)
        Bsz, S_, H, P = x.shape
        K.ssd_chunked_grad.launches += 1
        split = torch.zeros((Bsz, -(-S_ // chunk), H, 2, P, Bm.shape[3]), dtype=torch.bfloat16)
        return scan(x, dt, A, Bm, Cm, chunk), split

    def backward(x, dt, A, Bm, Cm, split, dy, chunk, groups=None):
        Bsz = x.shape[0]
        n = groups if groups is not None else 1 if A.dim() == 1 else A.shape[0]
        leaves = [t.detach().float().clone().requires_grad_(True)
                  for t in (x, dt, rows_of(A, Bsz), Bm, Cm)]
        with torch.enable_grad():
            dx, ddt, dA, dB, dC = torch.autograd.grad(scan(*leaves, chunk), leaves, dy)
        dA = dA.unflatten(0, (n, -1)).sum(1)
        K.ssd_chunked_grad_backward.launches += 1
        return (dx.to(x.dtype), ddt, dA[0] if groups is None and A.dim() == 1 else dA,
                dB.to(Bm.dtype), dC.to(Cm.dtype))

    monkeypatch.setattr(K, "_grad_forward", forward)
    monkeypatch.setattr(K, "_grad_backward", backward)


@pytest.mark.parametrize("banked,shared_A", [(True, False), (False, False), (False, True)])
def test_vmap_rules_fold_each_peers_A_as_the_plain_function(plain_kernels, banked, shared_A):
    """:class:`SsdChunkedFn` and its backward's Function, their ``vmap``
    rules folding the peers (and each peer's A) into one call, inside a
    ``RecomputeGroupFn``, on the CPU with ``plain_kernels`` for the kernels:
    a banked step (``vmap`` over ``grad_and_value``, A_log per peer), and the
    plain mean's ``grad_and_value`` over ``vmap`` with A_log per peer or
    shared, each against autograd of ``ssd_chunked`` peer by peer. Two
    forward calls (the group's and its recompute) and one backward call."""
    H, P, G, N, chunk = 4, 16, 2, 8, 64
    inputs = _banked_inputs(2, 2, 150, H, P, G, N, device="cpu", seed=9, shared_A=shared_A)
    ssd = lambda *a: K.SsdChunkedFn.apply(*a)[0]  # the CUDA route's Function, on the CPU
    before = (K.ssd_chunked_grad.launches, K.ssd_chunked_grad_backward.launches)
    grads, value = _banked_step(ssd, *inputs, H, P, G, N, chunk, banked=banked, shared_A=shared_A)
    assert (K.ssd_chunked_grad.launches, K.ssd_chunked_grad_backward.launches) == (
        before[0] + 2, before[1] + 1)
    want, want_value = _banked_plain(*inputs, H, P, G, N, chunk, banked=banked, shared_A=shared_A)
    assert torch.allclose(value, want_value, rtol=1e-5, atol=1e-7)
    for g, w, name in zip(grads, want, ("dA_log", "dconv", "ddt_raw")):
        assert g.shape == w.shape, name
        _hold(g, w, name)


def test_grad_route_takes_only_the_kernels_envelope():
    bf, f32 = torch.bfloat16, torch.float32

    def case(P=64, N=128, chunk=256, dtype=bf, device="meta"):
        x = torch.empty((2, 512, 4, P), dtype=dtype, device=device)
        Bm = torch.empty((2, 512, 1, N), dtype=dtype, device=device)
        return K.ssd_grad_takes(x, Bm, Bm, chunk)

    assert case() and case(P=32, N=64, chunk=64) and case(N=8, P=8, chunk=128)
    assert not case(device="cpu") and not case(dtype=f32)
    assert not case(P=72) and not case(P=60) and not case(N=136) and not case(N=12)
    assert not case(chunk=32) and not case(chunk=320) and not case(chunk=96)
    wide = torch.empty((2, 512, 4, 66), dtype=bf, device="meta")[..., :64]  # 132-byte rows
    Bm = torch.empty((2, 512, 1, 128), dtype=bf, device="meta")
    assert not K.ssd_grad_takes(wide, Bm, Bm, 256)


@pytest.mark.parametrize("device,dtype,chunk,with_state,use_kernel,expected", [
    ("meta", "bfloat16", 256, False, False, "ssd_chunked_grad"),
    ("meta", "bfloat16", 256, False, True, "ssd_scan"),
    ("meta", "bfloat16", 256, True, False, "ssd_chunked"),  # prefill fills the decode state
    ("meta", "float32", 256, False, False, "ssd_chunked"),
    ("meta", "bfloat16", 32, False, False, "ssd_chunked"),
    ("cpu", "bfloat16", 256, False, False, "ssd_chunked"),
])
def test_mamba2_apply_routes_by_what_the_input_shows(monkeypatch, device, dtype, chunk,
                                                    with_state, use_kernel, expected):
    import dataclasses

    cfg = dataclasses.replace(get_config("mamba2-370m"), d_model=128, ssm_headdim=64,
                              ssm_chunk=chunk, dtype=dtype, param_dtype="float32")
    mod = S.Mamba2(cfg, generator=torch.Generator().manual_seed(0), device="cpu").to(device)
    called = []
    for name in ("ssd_chunked_grad", "ssd_chunked", "ssd_scan"):
        fn = getattr(S, name)
        monkeypatch.setattr(S, name, lambda *a, _fn=fn, _n=name, **kw:
                            called.append(_n) or _fn(*a, **kw))
    x = torch.zeros((1, 512, cfg.d_model), dtype=getattr(torch, dtype), device=device)
    state = S.init_mamba2_state(cfg, 1, x.dtype, device=device) if with_state else None
    with torch.no_grad():
        S.mamba2_apply(mod, x, cfg, state=state, use_kernel=use_kernel)
    assert called == [expected]


def test_ssd_scan_still_refuses_grad_mode():
    """Reference behaviour 18: the scoring kernel has no backward; on a
    non-CPU tensor that requires grad it raises before any launch."""
    _, (x, dt, A, Bm, Cm) = _leaves(1, 256, 4, 64, 1, 128, device="meta")
    with pytest.raises(RuntimeError, match="reference behaviour 18"):
        K.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    with torch.no_grad():
        assert K.ssd_scan(x, dt, A, Bm, Cm, chunk=256).shape == x.shape


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")


def _hold(got, want, name):
    """``got`` within 5e-5 of max|want| of the plain f32 gradient ``want``,
    and where ``got`` is bf16 also within its rounding (half a bf16 ulp, at
    most 2^-8 |want|)."""
    rounded = got.dtype == torch.bfloat16
    got = got.float()
    scale = float(want.abs().max())
    err = (got - want).abs()
    limit = 5e-5 * scale + (2.0 ** -8 * want.abs() if rounded else 0.0)
    bad = err > limit
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} elements past the limit, worst {float(err.max()) / scale:.3e} "
        f"of max|g| {scale:.3e}")


def test_cuda_gradients_match_plain_at_the_cells_shape_on_strided_views(cuda):
    """mamba2-370m's (32, 2048, 32, 64), N 128, chunk 256, x, B and C the
    model's slices of one conv output; gradients through softplus and exp
    into the leaves, and dt's and A's own."""
    H, P, G, N = 32, 64, 1, 128
    leaves, views = _leaves(32, 2048, H, P, G, N, device="cuda", seed=11)
    dy = torch.randn((32, 2048, H, P), device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(5))
    y = K.ssd_chunked_grad(*views, 256)
    got = torch.autograd.grad(y, [*leaves, *views[1:3]], dy)
    plain = [leaves[0].detach().float().requires_grad_(True),
             *(t.detach().clone().requires_grad_(True) for t in leaves[1:])]
    plain_views = _views(*plain, H, P, G, N)
    want_y = K.ssd_chunked(*plain_views, 256)[0]
    want = torch.autograd.grad(want_y, [*plain, *plain_views[1:3]], dy)
    torch.cuda.synchronize()
    assert float((y - want_y).abs().max()) <= 2e-5 * float(want_y.detach().abs().max())
    for g, w, n in zip(got, want, ("dconv", "ddt_raw", "dA_log", "ddt", "dA")):
        _hold(g, w, n)


@pytest.mark.parametrize("B,S_,H,P,G,N,chunk", [
    (2, 700, 8, 64, 2, 128, 256),  # groups, a ragged last chunk of 188 rows
    (2, 2048, 16, 64, 1, 64, 256),  # zamba2's widths: N 64
    (3, 500, 4, 32, 4, 32, 128),  # a group a head, P 32
    (1, 64, 2, 16, 1, 8, 64),  # one chunk of one tile
    (2, 333, 6, 40, 3, 72, 192),  # three tiles, widths off the wgmma tile
])
def test_cuda_backward_matches_plain(cuda, B, S_, H, P, G, N, chunk):
    inputs, dy = _inputs_and_dy(B, S_, H, P, G, N, device="cuda", seed=B + S_ + N)
    got = K.ssd_chunked_grad_backward(*inputs, dy, chunk)
    want = _plain_grads(*inputs, dy, chunk)
    torch.cuda.synchronize()
    for g, w, t, n in zip(got, want, inputs, GRADS):
        assert g.dtype == t.dtype and g.shape == t.shape
        _hold(g, w, n)


def test_cuda_backward_repeats_bit_for_bit(cuda):
    inputs, dy = _inputs_and_dy(4, 2048, 32, 64, 1, 128, device="cuda", seed=8)
    first = K.ssd_chunked_grad_backward(*inputs, dy, 256)
    second = K.ssd_chunked_grad_backward(*inputs, dy, 256)
    torch.cuda.synchronize()
    bits = lambda t: t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)
    for a, b in zip(first, second):
        assert torch.equal(bits(a), bits(b))


def test_cuda_counts_one_launch_a_call_and_no_second_derivative(cuda):
    leaves, views = _leaves(2, 512, 8, 64, 1, 128, device="cuda", seed=2)
    before = (K.ssd_chunked_grad.launches, K.ssd_chunked_grad_backward.launches)
    y = K.ssd_chunked_grad(*views, 256)
    g, = torch.autograd.grad(y.square().sum(), [leaves[0]], create_graph=True)
    assert (K.ssd_chunked_grad.launches, K.ssd_chunked_grad_backward.launches) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad(g.float().sum(), [leaves[0]])


def _group_loss(positions, conv, params, H, P, G, N):
    dt_raw, A_log = params
    y = K.ssd_chunked_grad(*_views(conv, dt_raw, A_log, H, P, G, N), 256)
    return y.to(conv.dtype), torch.zeros((), device=conv.device)


def test_cuda_vmapped_peers_in_a_remat_group_match_plain(cuda):
    """The cell's call: grad_and_value of the peers' mean loss over ``vmap``,
    the SSD inside a ``RecomputeGroupFn``: one forward launch for the group,
    one for its recompute and one backward launch for both peers; the
    gradients as autograd of the plain function on the same inputs."""
    H, P, G, N = 8, 64, 1, 128
    (conv, dt_raw, A_log), _ = _leaves(4, 1024, H, P, G, N, device="cuda", seed=4)
    conv, dt_raw = conv.detach().unflatten(0, (2, 2)), dt_raw.detach().unflatten(0, (2, 2))
    A_log = A_log.detach()
    wgt = torch.randn((2, 2, 1024, H * P), device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(1))
    positions = torch.arange(1024, device="cuda")

    def run(positions, conv, params):
        return _group_loss(positions, conv, params, H, P, G, N)

    def loss(A_log, conv, dt_raw, wgt):
        y, _ = RecomputeGroupFn.apply(run, positions, conv, dt_raw, A_log)
        return (y.float().flatten(-2) * wgt).sum() / 1e3

    def mean_loss(A_log, conv, dt_raw, wgt):
        return torch.func.vmap(loss, in_dims=(None, 0, 0, 0))(A_log, conv, dt_raw, wgt).mean()

    before = (K.ssd_chunked_grad.launches, K.ssd_chunked_grad_backward.launches)
    grads, value = torch.func.grad_and_value(mean_loss, argnums=(0, 1, 2))(A_log, conv, dt_raw, wgt)
    assert (K.ssd_chunked_grad.launches, K.ssd_chunked_grad_backward.launches) == (
        before[0] + 2, before[1] + 1)

    leaves = [t.clone().float().requires_grad_(True) for t in (A_log, conv, dt_raw)]
    views = _views(leaves[1].flatten(0, 1), leaves[2].flatten(0, 1), leaves[0], H, P, G, N)
    y = K.ssd_chunked(*views, 256)[0].to(torch.bfloat16)
    ref = (y.float().flatten(-2) * wgt.flatten(0, 1)).sum() / 1e3 / 2
    want = torch.autograd.grad(ref, leaves)
    torch.cuda.synchronize()
    assert abs(float(value) - float(ref.detach())) <= 1e-4 * abs(float(ref.detach())) + 1e-6
    for g, w, n in zip(grads, want, ("dA_log", "dconv", "ddt_raw")):
        _hold(g, w, n)


@pytest.mark.parametrize("banked", [True, False])
def test_cuda_banked_peers_in_a_remat_group_match_plain(cuda, banked):
    """A banked step (``vmap`` over each peer's ``grad_and_value``) and the
    plain mean's ``grad_and_value`` over ``vmap``, each peer with its own
    A_log, the SSD inside a ``RecomputeGroupFn``: two forward launches and
    one backward launch for both peers; each peer's gradients as autograd of
    the plain function on its inputs."""
    H, P, G, N = 8, 64, 1, 128
    inputs = _banked_inputs(2, 2, 1024, H, P, G, N, device="cuda", seed=12)
    before = (K.ssd_chunked_grad.launches, K.ssd_chunked_grad_backward.launches)
    grads, value = _banked_step(K.ssd_chunked_grad, *inputs, H, P, G, N, 256, banked=banked)
    assert (K.ssd_chunked_grad.launches, K.ssd_chunked_grad_backward.launches) == (
        before[0] + 2, before[1] + 1)
    want, want_value = _banked_plain(*inputs, H, P, G, N, 256, banked=banked)
    torch.cuda.synchronize()
    assert torch.allclose(value, want_value, rtol=1e-4, atol=1e-6)
    for g, w, name in zip(grads, want, ("dA_log", "dconv", "ddt_raw")):
        assert g.shape == w.shape, name
        _hold(g, w, name)

