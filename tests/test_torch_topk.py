"""The port's top-k kernels and exchange protocols against the reference's,
on the CPU.

* The plain select equals the reference's Pallas ``topk_select_pack`` (in
  interpret mode) element for element, values and indices, including
  exact ties and leaves of mostly exact zeros, where the bisection bracket
  cannot close and the boundary tier fills by index; on tie-free input it
  selects the index set of ``lax.top_k`` (``kernels/ref.py``).
* The bisection's bracket is a function of max|x| and the k-th largest
  magnitude alone (the CUDA select's premise): a float32 replay from the
  two equals the plain version's bracket on normal, tied, mostly-zero,
  zero, denormal, +inf, equal-magnitude and NaN leaves, and the plain
  select on those leaves is the Pallas payload. The bank select's CPU
  route is the per-row select.
* The plain scatter equals the Pallas ``topk_scatter_accum`` and
  ``topk_scatter_ref`` bit for bit, peers sharing indices; so does every
  row of the bank scatter's CPU route (each mix of the full graph's and
  the ring's weights, each own row, which is also the offset P = 1
  scatter it replaced), on special payloads too; and the CUDA bodies'
  orders of adds, emulated in numpy, equal the plain scatter.
* ``topk`` and ``psum_mean``: host payloads, wire bytes and registry flags
  are the reference's; each device ``combine`` / ``combine_ef`` on the
  stacked ``(P, ...)`` bank matches the reference's under
  ``jax.vmap(axis_name="data")`` within 1e-6 (``qsgd`` with the
  reference's uniforms replayed).

The CUDA kernels are held against the plain versions by ``test_cuda_*``
(which skip without a card) and by ``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core.exchange import ExchangeContext as JContext
from repro.core.exchange import get_exchange as jget_exchange
from repro.core.graph import get_graph as jget_graph
from repro.kernels import ref as kref
from repro.kernels.topk import topk_scatter_accum as pallas_scatter
from repro.kernels.topk import topk_select_pack as pallas_select
from repro_torch import convert
from repro_torch.core import compression as C
from repro_torch.core import exchange as X
from repro_torch.core.graph import get_graph
from repro_torch.kernels import topk as K

torch.set_num_threads(2)  # the test workers share the CPU with each other

P = 4


def _leaf(n, kind, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    if kind == "ties":
        x = (np.round(x * 4) / 4).astype(np.float32)  # many exact magnitude ties
    elif kind == "mostly_zero":
        x[rng.random(n) < 0.97] = 0.0
        x[3], x[11] = 1e-25, -3e-38  # below max * 2**-64: the bracket stays open
    return x


@pytest.mark.parametrize("n", [300, 1000, 4097])
@pytest.mark.parametrize("kind", ["normal", "ties", "mostly_zero"])
def test_plain_select_is_the_pallas_payload(n, kind):
    x = _leaf(n, kind, seed=n)
    for k in (1, max(1, round(n * 0.01)), n):
        want_v, want_i = pallas_select(jnp.asarray(x), k)  # interpret mode
        got_v, got_i = K.topk_select_pack(torch.from_numpy(x), k)  # CPU -> plain
        assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v), err_msg=f"k={k}")
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i), err_msg=f"k={k}")


def test_plain_select_on_an_all_zero_leaf():
    x = np.zeros(301, np.float32)
    for k in (3, 301):
        v, i = K.topk_select_pack(torch.from_numpy(x), k)
        want_v, want_i = pallas_select(jnp.asarray(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(i.numpy(), np.arange(k))  # boundary tier by index
        assert not v.any()


@pytest.mark.parametrize("n,k", [(300, 3), (1000, 10), (4097, 41), (4097, 2000)])
def test_plain_select_picks_the_top_k_set_on_tie_free_input(n, k):
    x = np.random.default_rng(k).permutation(np.arange(1, n + 1)).astype(np.float32)
    x *= np.where(np.random.default_rng(n).random(n) < 0.5, -1, 1).astype(np.float32)
    v, i = K.topk_select_pack(torch.from_numpy(x), k)
    rv, ri = kref.topk_select_ref(jnp.asarray(x), k)
    assert set(i.tolist()) == set(np.asarray(ri).tolist())
    np.testing.assert_array_equal(v.numpy(), x[i.numpy()])


def _special_leaf(kind, n, seed):
    """Leaves where the bisection meets its edge cases."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    if kind == "nan":
        x[n // 2] = np.nan
    elif kind == "denormal":  # every magnitude below 2**-126
        x = (x * np.float32(1e-40)).astype(np.float32)
    elif kind == "inf":
        x[0] = np.inf
    elif kind == "infs":  # +inf and -inf, more of them than k
        x[[1, n // 3, n // 2, n - 1]] = [np.inf, -np.inf, np.inf, np.inf]
    elif kind == "equal":
        x = np.where(x < 0, -0.25, 0.25).astype(np.float32)
    elif kind == "zeros":
        x[:] = 0.0
    elif kind == "ties":
        x = (np.round(x * 4) / 4).astype(np.float32)
    elif kind == "mostly_zero":
        x[rng.random(n) < 0.97] = 0.0
        x[3], x[11] = 1e-25, -3e-38
    return x


# (kind, n, k): every case where the bisection's bracket is special
BRACKET_CASES = [
    ("normal", 1000, 10), ("normal", 1000, 1), ("normal", 1000, 1000), ("ties", 1000, 10),
    ("ties", 1000, 333), ("mostly_zero", 4097, 41), ("zeros", 301, 3), ("denormal", 500, 5),
    ("inf", 2, 1), ("inf", 1000, 10), ("infs", 1000, 2), ("infs", 1000, 4), ("equal", 1000, 10),
    ("nan", 1000, 10), ("normal", 1, 1),
]


def _radix_kth(mag, k):
    """The k-th largest of ``mag`` (f32 >= 0, counted with multiplicity) as
    the CUDA select finds it: three digits of the bit pattern (bits 30..20,
    19..9, 8..0), each the one that holds rank k among the entries that
    share the digits above it."""
    bits, rank, prefix = mag.view(np.uint32), k, 0
    for shift, width, above in ((20, 11, 31), (9, 11, 20), (0, 9, 9)):
        live = bits[(bits >> np.uint32(above)) == prefix]
        hist = np.bincount((live >> np.uint32(shift)) & ((1 << width) - 1), minlength=1 << width)
        from_top = np.cumsum(hist[::-1])
        d = (1 << width) - 1 - int(np.argmax(from_top >= rank))
        rank -= int(from_top[(1 << width) - 1 - d] - hist[d])
        prefix = prefix << width | d
    return np.uint32(prefix).view(np.float32)


@pytest.mark.parametrize("kind,n,k", BRACKET_CASES)
def test_bracket_is_a_replay_from_the_max_and_the_kth_magnitude(kind, n, k):
    """count(|x| >= mid) >= k exactly when mid <= T, T the k-th largest |x|:
    64 float32 steps from (max|x|, T) alone, with no read of x, give the
    plain version's bracket bit for bit (the premise of the CUDA select),
    and three radix digits of the bit patterns give T exactly."""
    x = _special_leaf(kind, n, seed=n + k)
    mag = np.abs(x)
    kth = np.sort(mag)[::-1][k - 1]  # NaN sorts last: first from the top
    if not np.isnan(mag).any():
        assert _radix_kth(mag, k).view(np.uint32) == kth.view(np.uint32)
    f = np.float32
    with np.errstate(invalid="ignore", over="ignore"):
        lo, hi = f(0.0), np.max(mag) * f(1.0 + 1e-6) + f(1e-30)
        for _ in range(K.BISECT_STEPS):  # all 64 steps: no exit at mid == hi
            mid = f(0.5) * (lo + hi)
            lo, hi = (mid, hi) if mid <= kth else (lo, mid)
    want_lo, want_hi = K.select_bracket(torch.from_numpy(mag), k)
    np.testing.assert_array_equal(np.array([lo, hi]), np.array([want_lo.item(), want_hi.item()]))
    if kind == "inf" and n == 2:
        assert lo == hi == np.inf


@pytest.mark.parametrize("kind,n,k", BRACKET_CASES)
def test_plain_select_on_special_leaves_is_the_pallas_payload(kind, n, k):
    """NaN (nothing kept: k zeros at index 0), +inf (also more +inf entries
    than k), equal magnitudes, one entry. XLA on the CPU flushes denormals
    to zero, so there the Pallas kernel sees a denormal leaf as all zeros;
    the port orders denormal magnitudes exactly (ROADMAP Queue 3 item 13):
    on that leaf its payload is the exact top-k by magnitude."""
    x = _special_leaf(kind, n, seed=n + k)
    got_v, got_i = K.topk_select_pack(torch.from_numpy(x), k)
    if kind == "denormal":  # tie-free: the top-k index set
        assert set(got_i.tolist()) == set(np.argsort(-np.abs(x))[:k].tolist())
        np.testing.assert_array_equal(got_v.numpy(), x[got_i.numpy()])
        return
    want_v, want_i = pallas_select(jnp.asarray(x), k)  # interpret mode
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    if kind == "nan":
        assert not got_v.any() and not got_i.any()


def test_bank_cpu_route_selects_each_row_through_topk_select_pack(monkeypatch):
    """Row p of the bank is ``topk_select_pack(x[p], k)``; on the CPU each
    row goes through that wrapper (so that patches of it, like the flip
    recorders of the device-step tests, see every select), and no launch
    is counted."""
    x = torch.from_numpy(np.stack([_leaf(1000, kind, seed=p) for p, kind in
                                   enumerate(["normal", "ties", "mostly_zero", "normal"])]))
    x[3, 7] = float("nan")
    seen, select = [], K.topk_select_pack
    monkeypatch.setattr(K, "topk_select_pack", lambda r, k: (seen.append(r), select(r, k))[1])
    before = select.launches
    v, i = K.topk_select_pack_bank(x, 10)
    assert select.launches == before
    assert v.shape == i.shape == (4, 10) and v.dtype == torch.float32 and i.dtype == torch.int32
    assert len(seen) == 4
    for p, r in enumerate(seen):
        np.testing.assert_array_equal(r.numpy(), x[p].numpy())
    for p in range(4):
        pv, pi = K.select_pack_plain(x[p], 10)
        assert torch.equal(v[p], pv) and torch.equal(i[p], pi)


def test_bank_validates_its_inputs():
    x = torch.zeros(3, 10)
    with pytest.raises(ValueError, match="out of range"):
        K.topk_select_pack_bank(x, 11)
    with pytest.raises(ValueError, match="out of range"):
        K.topk_select_pack_bank(x, 0)
    with pytest.raises(ValueError, match="float32"):
        K.topk_select_pack_bank(x.double(), 1)
    with pytest.raises(ValueError, match="2-d"):
        K.topk_select_pack_bank(x[0], 1)
    with pytest.raises(ValueError, match="contiguous"):
        K.topk_select_pack_bank(x.t(), 1)
    with pytest.raises(ValueError, match="at least one row"):
        K.topk_select_pack_bank(x[:0], 1)


@pytest.mark.parametrize("k,n", [(50, 300), (128, 4097), (7, 7)])
def test_plain_scatter_is_bit_identical_to_the_reference(k, n):
    rng = np.random.default_rng(k + n)
    vals = rng.normal(size=(P, k)).astype(np.float32)
    # peers share indices: each peer draws from the same small pool
    pool = rng.choice(n, size=min(n, 2 * k), replace=False)
    idx = np.stack([rng.choice(pool, size=k, replace=False) for _ in range(P)]).astype(np.int32)
    w = rng.random(P).astype(np.float32)
    got = K.topk_scatter_accum(torch.from_numpy(vals), torch.from_numpy(idx),
                               torch.from_numpy(w), n).numpy()
    args = (jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(w), n)
    np.testing.assert_array_equal(got, np.asarray(pallas_scatter(*args)))
    np.testing.assert_array_equal(got, np.asarray(kref.topk_scatter_ref(*args)))


def _bank_payload(P, k, n, seed, wire="bfloat16"):
    """A bank as the device step hands it to the scatter: each peer's k
    distinct indices in [0, n), its values unrounded (vals) and rounded
    through the wire dtype (vbank)."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(n, size=k, replace=False) for _ in range(P)]).astype(np.int32)
    vals = rng.normal(size=(P, k)).astype(np.float32)
    vbank = torch.from_numpy(vals).to(getattr(torch, wire)).float().numpy()
    return vbank, vals, idx


def _mixing(graph, P):
    """The exchange's (M, P) mixing weights: one row of 1/P on the full
    graph, the Metropolis-Hastings matrix's P rows otherwise."""
    if graph == "full":
        return np.full((1, P), 1.0 / P, np.float32)
    return get_graph(graph, P).mixing_matrix().astype(np.float32)


def _same_bits(a, b):
    """NaN at the same positions, the same bit pattern elsewhere."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    live = ~np.isnan(a)
    np.testing.assert_array_equal(a[live].view(np.uint32), b[live].view(np.uint32))


def _pallas_rows(vbank, vals, idx, W, n):
    """The bank's rows through the Pallas kernel (interpret mode) and
    ``topk_scatter_ref``: each mix, then each own row as a P = 1 scatter
    with weight 1."""
    rows = [(vbank, idx, w) for w in W]
    if vals is not None:
        rows += [(vals[p:p + 1], idx[p:p + 1], np.ones(1, np.float32)) for p in range(len(vals))]
    args = [(jnp.asarray(v), jnp.asarray(i), jnp.asarray(w), n) for v, i, w in rows]
    return [np.asarray(pallas_scatter(*a)) for a in args], [np.asarray(kref.topk_scatter_ref(*a)) for a in args]


@pytest.mark.parametrize("own", [False, True])
@pytest.mark.parametrize("graph", ["full", "ring"])
@pytest.mark.parametrize("P", [1, 3, 4])
def test_bank_rows_are_the_pallas_scatter(P, graph, own):
    """Every row of the bank's CPU route equals the Pallas scatter and
    ``topk_scatter_ref`` bit for bit: the M mixes (M = 1 on the full graph,
    P under the ring's W) and, with ``vals``, each peer's own image."""
    n, k = 1000, 37
    vbank, vals, idx = _bank_payload(P, k, n, seed=P * 10 + own)
    W = _mixing(graph, P)
    before = K.topk_scatter_accum.launches
    mixed, own_rows = K.topk_scatter_accum_bank(
        torch.from_numpy(vbank), torch.from_numpy(vals) if own else None, torch.from_numpy(idx),
        torch.from_numpy(W), n)
    assert K.topk_scatter_accum.launches == before  # the CPU route launches nothing
    assert mixed.shape == (len(W), n) and mixed.dtype == torch.float32
    assert (own_rows is None) == (not own)
    got = list(mixed.numpy()) + ([] if own_rows is None else list(own_rows.numpy()))
    pallas, ref = _pallas_rows(vbank, vals if own else None, idx, W, n)
    assert len(got) == len(pallas) == len(W) + (P if own else 0)
    for g, a, b in zip(got, pallas, ref):
        _same_bits(g, a)
        _same_bits(g, b)


@pytest.mark.parametrize("P", [1, 3, 4])
def test_own_rows_are_the_offset_scatter(P):
    """Own row p equals what the exchange computed before the bank: one P = 1
    scatter of every peer's entries at p * n + idx into a (P * n) buffer,
    weight 1."""
    n, k = 700, 21
    vbank, vals, idx = _bank_payload(P, k, n, seed=P)
    _, own = K.topk_scatter_accum_bank(torch.from_numpy(vbank), torch.from_numpy(vals),
                                       torch.from_numpy(idx), torch.from_numpy(_mixing("full", P)), n)
    offset = (np.arange(P, dtype=np.int32)[:, None] * n).astype(np.int32)
    dense = K.topk_scatter_accum(torch.from_numpy(vals.reshape(1, -1)),
                                 torch.from_numpy((idx + offset).reshape(1, -1)), torch.ones(1), P * n)
    _same_bits(own.numpy(), dense.view(P, n).numpy())


def _special_payload(P, k, n, seed):
    """Peer 0: values -0.0, +inf, NaN, -inf and indices below 0 and at or
    past n; peer 1: a NaN leaf's payload (k slots of value 0 at index 0);
    the others random pairs, two of them at peer 0's -0.0 and +inf
    indices (the indices within a peer distinct but for the NaN payload)."""
    vbank, vals, idx = _bank_payload(P, k, n, seed, wire="float32")
    vals[0, :5] = [-0.0, np.inf, np.nan, -np.inf, -0.0]
    idx[0, 5:9] = [-1, -7, n, n + 100]
    if P > 1:
        vals[1], idx[1] = 0.0, 0
    for p in range(2, P):
        rest = [t for t in idx[p] if t not in idx[0, :2]][: k - 2]
        idx[p] = np.concatenate([idx[0, :2], rest])
        vals[p, 0] = -0.0
    return vals.copy(), vals, idx


@pytest.mark.parametrize("graph", ["full", "ring"])
@pytest.mark.parametrize("P", [1, 3, 4])
def test_bank_on_special_payloads_is_the_reference(P, graph):
    """-0.0, +inf, NaN and -inf values, a NaN leaf's payload (index 0 k
    times, value 0) and indices outside [0, n), with own rows: every row
    equals the Pallas scatter (n % 128 != 0, where the Pallas kernel drops
    negative indices in its padding) and ``topk_scatter_ref`` on the
    indices at or past n (it wraps negative ones, Python style; the port
    and the Pallas kernel drop them); under the ring's zero weights, +inf
    x 0 makes NaN in both."""
    n, k = 300, 16
    vbank, vals, idx = _special_payload(P, k, n, seed=P)
    W = _mixing(graph, P)
    mixed, own = K.topk_scatter_accum_bank(torch.from_numpy(vbank), torch.from_numpy(vals),
                                           torch.from_numpy(idx), torch.from_numpy(W), n)
    got = list(mixed.numpy()) + list(own.numpy())
    pallas, _ = _pallas_rows(vbank, vals, idx, W, n)
    _, ref = _pallas_rows(vbank, vals, np.where(idx < 0, n + 1, idx).astype(np.int32), W, n)
    for g, a, b in zip(got, pallas, ref):
        _same_bits(g, a)
        _same_bits(g, b)
    assert np.isnan(got[len(W)]).any()  # peer 0's own image keeps its NaN


def _emulate(vals, idx, w, n, tile, body, rng):
    """The CUDA scatter's order in numpy float32, one mix row: the tile
    body (each tile zeroed, every peer's pairs streamed in turn, those in
    the tile added) or the long-row body (pairs sent to buckets (tile,
    peer) in a shuffled order, as its atomics may place them, then each
    tile's buckets added peer by peer)."""
    out = np.zeros(n, np.float32)
    P = len(vals)
    live = (idx >= 0) & (idx < n)
    buckets = {}
    if body == "long":
        for p in range(P):
            for j in rng.permutation(idx.shape[1]):
                if live[p, j]:
                    buckets.setdefault((idx[p, j] // tile, p), []).append((idx[p, j], vals[p, j]))
    for lo in range(0, n, tile):
        acc = np.zeros(min(tile, n - lo), np.float32)
        for p in range(P):
            if body == "tile":
                sel = live[p] & (idx[p] >= lo) & (idx[p] < lo + tile)
                pairs = zip(idx[p][sel], vals[p][sel])
            else:
                pairs = buckets.get((lo // tile, p), [])
            for t, v in pairs:
                acc[t - lo] = np.float32(acc[t - lo] + np.float32(v * w[p]))
        out[lo:lo + len(acc)] = acc
    return out


@pytest.mark.parametrize("body", ["tile", "long"])
@pytest.mark.parametrize("n", [1000, 1003])
def test_kernel_order_emulation_is_the_plain_scatter(body, n):
    """The tile body's and the long-row body's order of adds, emulated in
    numpy float32 at a small tile (64, tile edges falling between a peer's
    entries, n not a multiple of it), equals ``scatter_accum_plain`` bit
    for bit: peers sharing indices, out-of-range indices, -0.0 and +inf."""
    P, k, tile = 4, 120, 64
    rng = np.random.default_rng(n)
    pool = rng.choice(n, size=2 * k, replace=False)
    idx = np.stack([rng.choice(pool, size=k, replace=False) for _ in range(P)]).astype(np.int32)
    idx[0, :2] = [-3, n + 5]
    vals = rng.normal(size=(P, k)).astype(np.float32)
    vals[1, :2] = [-0.0, np.inf]
    w = rng.random(P).astype(np.float32)
    want = K.scatter_accum_plain(torch.from_numpy(vals), torch.from_numpy(idx), torch.from_numpy(w), n)
    _same_bits(_emulate(vals, idx, w, n, tile, body, rng), want.numpy())


def test_bank_validates_and_the_exchange_scatters_once_per_leaf(monkeypatch):
    """Shapes, dtypes and devices are checked; the top-k exchange's device
    combine makes one bank scatter per leaf, with the unrounded values
    (own rows) under EF only."""
    v, i, W = torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.int32), torch.ones(1, 2)
    with pytest.raises(ValueError, match=r"must be \(2, 3\), \(2, 3\) and \(M >= 1, 2\)"):
        K.topk_scatter_accum_bank(v, None, i, torch.ones(1, 3), 5)
    with pytest.raises(ValueError, match=r"must be \(2, 3\)"):
        K.topk_scatter_accum_bank(v, v[:1].contiguous(), i, W, 5)
    with pytest.raises(ValueError, match="out of range"):
        K.topk_scatter_accum_bank(v, None, i, W, 2**31)
    with pytest.raises(ValueError, match="int32"):
        K.topk_scatter_accum_bank(v, None, i.long(), W, 5)
    calls, bank = [], K.topk_scatter_accum_bank
    monkeypatch.setattr(K, "topk_scatter_accum_bank",
                        lambda vb, vl, ix, w, n: (calls.append((vl is not None, tuple(w.shape))),
                                                  bank(vb, vl, ix, w, n))[1])
    grads = _leaf_tree(2, peers=P)
    ring = get_graph("ring", P)
    ctx = X.ExchangeContext(num_peers=P, topk_frac=0.1, graph=ring, mixing=ring.mixing_matrix())
    X.get_exchange("topk").combine_ef(grads, ctx)
    X.get_exchange("topk").combine(grads, X.ExchangeContext(num_peers=P, topk_frac=0.1))
    assert calls == [(True, (P, P))] * len(grads) + [(False, (1, P))] * len(grads)


def test_wrappers_validate_inputs_and_count_no_cpu_launch():
    x = torch.zeros(10)
    with pytest.raises(ValueError, match="out of range"):
        K.topk_select_pack(x, 11)
    with pytest.raises(ValueError, match="out of range"):
        K.topk_select_pack(x, 0)
    with pytest.raises(ValueError, match="float32"):
        K.topk_select_pack(x.double(), 1)
    v, i, w = torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.int32), torch.ones(2)
    with pytest.raises(ValueError, match=r"must be \(2, 3\) and \(2,\)"):
        K.topk_scatter_accum(v, i[:, :2].contiguous(), w, 5)
    with pytest.raises(ValueError, match="int32"):
        K.topk_scatter_accum(v, i.long(), w, 5)
    before = (K.topk_select_pack.launches, K.topk_scatter_accum.launches)
    K.topk_scatter_accum(v, i, w, 5)
    K.topk_select_pack(x, 3)
    assert (K.topk_select_pack.launches, K.topk_scatter_accum.launches) == before


# ---------------------------------------------------------------------------
# protocols: host path, accounting, registry
# ---------------------------------------------------------------------------


def _leaf_tree(seed, peers=None):
    """Leaves in the port's layout (conv OIHW, linear (out, in), bias), with
    a stacked peer dimension in front when ``peers`` is set."""
    g = torch.Generator().manual_seed(seed)
    lead = () if peers is None else (peers,)
    return {
        "conv.b": torch.randn(*lead, 24, generator=g),
        "conv.w": torch.randn(*lead, 24, 3, 5, 5, generator=g),
        "fc.w": torch.randn(*lead, 10, 70, generator=g),
    }


def _to_jax_tree(tree, lead=0):
    j = {k: jnp.asarray(convert.to_jax_layout(v, lead=lead).numpy()) for k, v in tree.items()}
    return {"conv": {"b": j["conv.b"], "w": j["conv.w"]}, "fc": {"w": j["fc.w"]}}


def _jleaves(tree):
    return dict(zip(["conv.b", "conv.w", "fc.w"], jax.tree_util.tree_leaves(tree)))


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("frac", [0.01, 0.3])
def test_topk_host_payload_and_wire_bytes_are_the_reference(wire, frac):
    tree = _leaf_tree(0)
    ctx = X.ExchangeContext(num_peers=P, topk_frac=frac, wire_dtype=getattr(torch, wire),
                            graph=get_graph("ring", P))
    jctx = JContext(num_peers=P, topk_frac=frac, wire_dtype=jnp.dtype(wire), topk_impl="kernel",
                    graph=jget_graph("ring", P))
    proto, jproto = X.get_exchange("topk"), jget_exchange("topk")
    payload, nbytes = proto.host_encode(tree, ctx)
    jpayload, jnbytes = jproto.host_encode(_to_jax_tree(tree), jctx)
    assert nbytes == jnbytes
    assert list(payload) == ["conv.b", "conv.w", "fc.w"]
    jp = jax.tree_util.tree_leaves(jpayload, is_leaf=lambda p: isinstance(p, dict) and "values" in p)
    for p, q in zip(payload.values(), jp):
        assert p["values"].dtype == getattr(torch, wire)
        np.testing.assert_array_equal(p["values"].float().numpy(), np.asarray(q["values"], np.float32))
        np.testing.assert_array_equal(p["idx"].numpy(), np.asarray(q["idx"]))
        np.testing.assert_array_equal(p["shape"], q["shape"])
    dense = proto.host_decode(payload, tree, ctx)
    jdense = _jleaves(jproto.host_decode(jpayload, _to_jax_tree(tree), jctx))
    for k, d in dense.items():
        assert d.shape == tree[k].shape
        np.testing.assert_array_equal(convert.to_jax_layout(d).numpy(), np.asarray(jdense[k]))
    for name in ("topk", "psum_mean", "allgather_mean"):
        p, q = X.get_exchange(name), jget_exchange(name)
        jtree = _to_jax_tree(tree)
        full = dataclasses.replace(ctx, graph=get_graph("full", P))
        jfull = dataclasses.replace(jctx, graph=jget_graph("full", P))
        for c, jc in ((ctx, jctx), (full, jfull)):
            assert p.wire_bytes_per_edge(tree, c) == q.wire_bytes_per_edge(jtree, jc)
            assert p.wire_bytes(tree, c) == q.wire_bytes(jtree, jc)
            assert p.host_wire_bytes(tree, c) == q.host_wire_bytes(jtree, jc)


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_psum_mean_host_payload_is_the_reference(wire):
    tree = _leaf_tree(1)
    ctx = X.ExchangeContext(num_peers=P, wire_dtype=getattr(torch, wire))
    jctx = JContext(num_peers=P, wire_dtype=jnp.dtype(wire))
    payload, nbytes = X.get_exchange("psum_mean").host_encode(tree, ctx)
    jpayload, jnbytes = jget_exchange("psum_mean").host_encode(_to_jax_tree(tree), jctx)
    assert nbytes == jnbytes
    for k, q in _jleaves(jpayload).items():
        np.testing.assert_array_equal(
            convert.to_jax_layout(payload[k]).float().numpy(), np.asarray(q, np.float32))


@pytest.mark.parametrize("name", ["allgather_mean", "psum_mean", "qsgd", "topk"])
def test_registry_names_and_flags_are_the_reference(name):
    p, q = X.get_exchange(name), jget_exchange(name)
    assert p.name == q.name == name
    for flag in ("is_async", "requires_key", "decomposes_per_edge", "requires_full_graph",
                 "sharded", "lossy", "hierarchical"):
        assert getattr(p, flag) == getattr(q, flag), flag


# ---------------------------------------------------------------------------
# protocols: device combine on the stacked bank
# ---------------------------------------------------------------------------


def _replay_combine_uniforms(monkeypatch, key, num_leaves):
    """The reference's uniforms for a combine under vmap: peer p's leaf i
    draws ``uniform(split(fold_in(key, p), L)[i], (nb, bucket))``."""
    calls = iter(range(num_leaves))

    def draw(shape, generator):
        i = next(calls)
        peers, nb, bucket = shape
        u = [jax.random.uniform(jax.random.split(jax.random.fold_in(key, p), num_leaves)[i],
                                (nb, bucket), jnp.float32) for p in range(peers)]
        return torch.from_numpy(np.stack([np.asarray(a) for a in u]))

    monkeypatch.setattr(C, "draw_uniforms", draw)


CASES = [
    ("allgather_mean", "full", "float32", {}),
    ("allgather_mean", "ring", "bfloat16", {}),
    ("psum_mean", "full", "float32", {}),
    ("psum_mean", "full", "bfloat16", {}),
    ("qsgd", "full", "float32", {"qsgd": (7, 256)}),
    ("qsgd", "ring", "float32", {"qsgd": (127, 128)}),
    ("topk", "full", "float32", {"topk_frac": 0.05}),
    ("topk", "ring", "bfloat16", {"topk_frac": 0.2}),
    ("topk", "full", "float32", {"topk_frac": 1.0}),
]


@pytest.mark.parametrize("name,graph,wire,kw", CASES)
def test_device_combine_matches_the_reference_under_vmap(monkeypatch, name, graph, wire, kw):
    grads = _leaf_tree(2, peers=P)
    key = jax.random.PRNGKey(7)
    common = dict(num_peers=P)
    jkw = dict(kw, qsgd=JC.QSGDConfig(*kw["qsgd"])) if "qsgd" in kw else dict(kw)
    tkw = dict(kw, qsgd=C.QSGDConfig(*kw["qsgd"])) if "qsgd" in kw else dict(kw)
    jgraph, tgraph = jget_graph(graph, P), get_graph(graph, P)
    jmix = None if graph == "full" else jgraph.mixing_matrix().astype(np.float32)
    tmix = None if graph == "full" else tgraph.mixing_matrix().astype(np.float32)
    jctx = JContext(axis="data", wire_dtype=jnp.dtype(wire), graph=jgraph, mixing=jmix, **common, **jkw)
    ctx = X.ExchangeContext(wire_dtype=getattr(torch, wire), graph=tgraph, mixing=tmix, **common, **tkw)
    jproto, proto = jget_exchange(name), X.get_exchange(name)
    jkey = key if jproto.requires_key else None

    def body(g):
        avg, local, _ = jproto.combine_ef(g, jctx, key=jkey)
        plain, _ = jproto.combine(g, jctx, key=jkey)
        return avg, local, plain

    javg, jlocal, jplain = (_jleaves(t) for t in jax.vmap(body, axis_name="data")(_to_jax_tree(grads, 1)))
    gen = torch.Generator() if proto.requires_key else None
    _replay_combine_uniforms(monkeypatch, key, len(grads))
    avg, local, _ = proto.combine_ef(grads, ctx, generator=gen)
    _replay_combine_uniforms(monkeypatch, key, len(grads))
    plain, _ = proto.combine(grads, ctx, generator=gen)
    for k in grads:
        for ours, theirs in ((avg, javg), (local, jlocal), (plain, jplain)):
            assert ours[k].shape == grads[k].shape
            got = convert.to_jax_layout(ours[k], lead=1).float().numpy()
            np.testing.assert_allclose(got, np.asarray(theirs[k], np.float32), rtol=0, atol=1e-6,
                                       err_msg=k)


def test_psum_mean_refuses_a_sparse_overlay():
    ctx = X.ExchangeContext(num_peers=P, graph=get_graph("ring", P),
                            mixing=get_graph("ring", P).mixing_matrix())
    with pytest.raises(ValueError, match="graph='full'"):
        X.get_exchange("psum_mean").combine(_leaf_tree(0, peers=P), ctx)
    with pytest.raises(ValueError, match="graph='full'"):
        X.check_overlay(X.get_exchange("psum_mean"), get_graph("ring", P))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")


@pytest.mark.parametrize("n,kind", [(4096 * 4096, "normal"), (301, "ties"), (4097, "mostly_zero")])
def test_cuda_kernels_match_plain(cuda, n, kind):
    x = torch.from_numpy(_leaf(n, kind, seed=3)).cuda()
    for k in (1, max(1, round(n * 0.01)), n):
        v, i = K.topk_select_pack(x, k)
        pv, pi = K.select_pack_plain(x, k)
        assert torch.equal(v, pv) and torch.equal(i, pi)
    vals = torch.stack([v] * P) * torch.arange(1, P + 1, device="cuda")[:, None]
    idx = torch.stack([i] * P)  # every peer shares every index
    w = torch.rand(P, device="cuda")
    assert torch.equal(K.topk_scatter_accum(vals, idx, w, n), K.scatter_accum_plain(vals, idx, w, n))


@pytest.mark.parametrize("body", [0, 1, 2])
@pytest.mark.parametrize("graph", ["full", "ring"])
def test_cuda_scatter_bank_matches_plain(cuda, graph, body):
    """The bank scatter on the card, in one launch, the wrapper's body (0)
    and each body forced: every mix and own row bit-identical to the
    plain version (NaN at the same positions), on a select-like payload
    over ragged tiles and on the special payloads."""
    W = _mixing(graph, P)
    for n, payload in ((100003, _bank_payload(P, 1000, 100003, seed=1)),
                       (300, _special_payload(P, 16, 300, seed=2))):
        args = [torch.from_numpy(a).cuda() for a in payload]
        before = K.topk_scatter_accum.launches
        if body:
            rows = K.scatter_launch(*args, torch.from_numpy(W).cuda(), n, body)
        else:
            mixed, own = K.topk_scatter_accum_bank(*args, torch.from_numpy(W).cuda(), n)
            rows = torch.cat([mixed, own])
        assert K.topk_scatter_accum.launches == before + 1
        mixed, own = K.topk_scatter_accum_bank(*(torch.from_numpy(a) for a in payload),
                                               torch.from_numpy(W), n)
        _same_bits(rows.cpu().numpy(), torch.cat([mixed, own]).numpy())


@pytest.mark.parametrize("kind,n,k", BRACKET_CASES)
def test_cuda_select_on_special_leaves_matches_plain(cuda, kind, n, k):
    x = torch.from_numpy(_special_leaf(kind, n, seed=n + k)).cuda()
    v, i = K.topk_select_pack(x, k)
    pv, pi = K.select_pack_plain(x, k)
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("step", [-1, 0, 1])
def test_cuda_bank_is_one_launch_and_row_identical(cuda, step):
    """Rows at the one-block body's threshold - 1, at it and + 1 (the grid
    body), each row identical to the plain version, in one launch."""
    n = K.small_row_max() + step
    x = torch.from_numpy(np.stack([_leaf(n, kind, seed=n + p) for p, kind in
                                   enumerate(["normal", "ties", "mostly_zero", "normal"])])).cuda()
    k = max(1, round(n * 0.01))
    before = K.topk_select_pack.launches
    v, i = K.topk_select_pack_bank(x, k)
    assert K.topk_select_pack.launches == before + 1
    for p in range(4):
        pv, pi = K.select_pack_plain(x[p], k)
        assert torch.equal(v[p], pv) and torch.equal(i[p], pi)
