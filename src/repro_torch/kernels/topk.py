"""Top-k select-and-pack / scatter-accumulate: CUDA kernels for Hopper beside
their plain PyTorch versions.

Replaces the Pallas TPU kernels ``repro/kernels/topk.py:topk_select_pack``
(``_select_kernel``) and ``topk_scatter_accum`` (``_scatter_kernel``). The
CUDA source is ``csrc/topk.cu``; its header says how the select finds the
bisection's bracket from max|x| and the exact k-th magnitude (three radix
passes), which rows take one block and which a cooperative grid, how the
scatter's two bodies (tiles in shared memory; pairs bucketed by tile for
long rows) keep the reference's peer order, and what bounds each kernel.
``topk_select_pack_bank`` selects every row of a ``(P, n)`` bank in one
launch; ``topk_scatter_accum_bank`` scatters a leaf's bank into every mix
and every peer's own image in one.

The select is the Pallas kernel's algorithm, not an exact top-k: a 64-step
float32 bisection on the magnitude threshold from ``lo = 0`` and
``hi = max|x| * f32(1 + 1e-6) + f32(1e-30)``; every entry with
``|x| >= hi`` is kept, the remaining slots are filled with the boundary
entries ``lo <= |x| < hi`` in ascending index order, and the output lists
the kept entries first and then the boundary ones, each in index order.
So the payload equals the reference kernel's element for element, also
where the bracket cannot close (a k-th magnitude below about
``max * 2**-64``, as in a leaf of mostly exact zeros), on a leaf holding a
NaN (the max is NaN, so is ``hi``, and no entry is kept: every slot holds
value 0 and index 0) and on one with more than k entries at +inf (the first
k of them, by index, as the Pallas kernel's padded banks drop the rest).

A wrapper takes its plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel, or raises: there is no fallback. Each
wrapper counts its kernel launches in its ``launches`` attribute. For a
meta tensor (the dry run) a launch allocates its outputs (not the long-row
scatter's scratch, which the built library sizes) and charges
``topk_select_cost`` / ``topk_scatter_cost``, the formulas of the kernels'
bounds, without a launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cost import topk_scatter_cost, topk_select_cost

SOURCE = "topk.cu"
BISECT_STEPS = 64
MAX_GRID = 4096  # blocks of the select's cooperative grid, at most


def select_bracket(mag: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Pallas kernel's 64-step float32 bisection on the magnitudes
    ``mag`` (n,): ``(lo, hi)`` with ``count(mag >= lo) >= k`` and
    ``count(mag >= hi) < k`` wherever the max is finite."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=mag.device)
    lo = f32(0.0)
    hi = mag.max() * f32(1.0 + 1e-6) + f32(1e-30)
    for _ in range(BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        big = (mag >= mid).sum() >= k
        lo, hi = torch.where(big, mid, lo), torch.where(big, hi, mid)
    return lo, hi


def select_pack_plain(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch select: (n,) f32 -> (values f32 (k,), indices int32
    (k,)), the Pallas kernel's bisection and two-tier pack step for step."""
    n = x.shape[0]
    mag = x.abs()
    lo, hi = select_bracket(mag, k)
    sure = mag >= hi
    edge = (mag >= lo) & (mag < hi)
    n_sure = sure.sum()
    edge_rank = torch.cumsum(edge, 0) - 1
    slot = torch.where(sure, torch.cumsum(sure, 0) - 1, n_sure + edge_rank)
    # slots past k exist only where more than k entries are +inf
    take = (sure | (edge & (edge_rank < k - n_sure))) & (slot < k)
    index = torch.arange(n, device=x.device)[take]
    vals = torch.zeros((k,), dtype=torch.float32, device=x.device)
    idx = torch.zeros((k,), dtype=torch.int32, device=x.device)
    vals[slot[take]] = x[index]
    idx[slot[take]] = index.to(torch.int32)
    return vals, idx


def scatter_accum_plain(
    vals: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, n: int
) -> torch.Tensor:
    """Plain PyTorch ``sum_p w[p] * scatter(vals[p], idx[p])`` -> (n,) f32:
    ``out[idx[p, j]] += vals[p, j] * w[p]``, peers added in the order
    p = 0 .. P-1, indices outside [0, n) dropped."""
    out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
    for p in range(vals.shape[0]):
        keep = (idx[p] >= 0) & (idx[p] < n)
        out.index_add_(0, idx[p][keep].to(torch.int64), (vals[p] * w[p])[keep])
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.topk_select_small_row_max.argtypes = []
    lib.topk_select_small_row_max.restype = ctypes.c_longlong
    lib.topk_select_scratch_words.argtypes = [ctypes.c_int]
    lib.topk_select_scratch_words.restype = ctypes.c_int
    lib.topk_select_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.topk_select_launch.restype = ctypes.c_int
    for name, args, res in (
        ("topk_scatter_tile", [], ctypes.c_int),
        ("topk_scatter_tile_pairs_max", [], ctypes.c_longlong),
        ("topk_scatter_tile_reads_max", [ctypes.c_int, ctypes.c_longlong], ctypes.c_longlong),
        ("topk_scatter_body",
         [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int], ctypes.c_int),
        ("topk_scatter_counter_words", [ctypes.c_int, ctypes.c_longlong], ctypes.c_longlong),
        ("topk_scatter_work_words",
         [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int], ctypes.c_longlong),
    ):
        getattr(lib, name).argtypes, getattr(lib, name).restype = args, res
    lib.topk_scatter_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.topk_scatter_launch.restype = ctypes.c_int
    return lib


def load_library() -> None:
    """Build and load the kernels ahead of their first launch."""
    _lib()


def small_row_max() -> int:
    """Rows of at most this many entries take the select's one-block body
    (``csrc/topk.cu``); longer rows take its cooperative grid."""
    return int(_lib().topk_select_small_row_max())


def scatter_tile() -> int:
    """Entries of one output tile of the scatter (``csrc/topk.cu``)."""
    return int(_lib().topk_scatter_tile())


def scatter_tile_pairs_max() -> int:
    """Scatter launches whose rows span more than one tile take the long-row
    body when their P x k pairs exceed this (the pairs one block of the
    tile body reads)."""
    return int(_lib().topk_scatter_tile_pairs_max())


def scatter_tile_reads_max(rows: int, n: int) -> int:
    """Scatter launches of ``rows`` rows of ``n`` that span more than one
    tile take the long-row body when tiles x (M + 1 with own rows, else M)
    x P x k exceeds this (the pairs all blocks of the tile body read)."""
    return int(_lib().topk_scatter_tile_reads_max(rows, n))


def scatter_body(mixes: int, peers: int, k: int, n: int, own: bool) -> int:
    """The scatter body a launch of ``mixes`` mixes of ``peers`` x ``k``
    pairs into rows of ``n``, with or without own rows, takes: 1 the tile
    body, 2 the long-row body."""
    return int(_lib().topk_scatter_body(mixes, peers, k, n, int(own)))


_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def _select_scratch(device: torch.device, stream: int) -> torch.Tensor:
    """The grid body's scratch for ``stream``: zeroed once, and left zero
    by every launch (``csrc/topk.cu``), so no launch needs a memset. Each
    stream has its own, since two launches may not share it at once."""
    key = (device.index, stream)
    if key not in _scratch:
        words = _lib().topk_select_scratch_words(MAX_GRID)
        _scratch[key] = torch.zeros((words,), dtype=torch.int32, device=device)
    return _scratch[key]


def _check_k(n: int, k: int) -> None:
    if not 1 <= k <= n < 2**31:
        raise ValueError(f"k={k} out of range for n={n} (1 <= k <= n < 2**31)")


def select_launch(x: torch.Tensor, k: int, body: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the select over every row of a CUDA (rows, n) bank ->
    (values (rows, k), indices (rows, k)). ``body``: 0 by the row length
    (``small_row_max``), 1 one block per row, 2 the cooperative grid."""
    rows, n = x.shape
    meta = build.on_meta(x)
    stream = None if meta else build.cuda_stream(x.device)
    vals = torch.empty((rows, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((rows, k), dtype=torch.int32, device=x.device)
    if not meta:
        with torch.cuda.device(x.device):
            err = _lib().topk_select_launch(
                x.data_ptr(), rows, n, k, vals.data_ptr(), idx.data_ptr(),
                _select_scratch(x.device, stream.value or 0).data_ptr(), MAX_GRID, body, stream,
            )
        if err:
            raise RuntimeError(f"topk_select_pack kernel launch failed at ({rows}, {n}), k={k}: "
                               f"cudaError {err}")
        topk_select_pack.launches += 1
    build.charge("topk_select_pack", *topk_select_cost(rows, n, k))
    return vals, idx


def topk_select_pack(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (n,) f32 -> (values f32 (k,), indices int32 (k,)) of the k largest
    |x| by the bisection-threshold rule (module docstring)."""
    build.check_tensor(x, "x", torch.float32, 1)
    n = x.shape[0]
    _check_k(n, k)
    if x.device.type == "cpu":
        return select_pack_plain(x, k)
    vals, idx = select_launch(x.view(1, n), k)
    return vals[0], idx[0]


topk_select_pack.launches = 0


def topk_select_pack_bank(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (P, n) f32 -> (values f32 (P, k), indices int32 (P, k)); row p is
    ``topk_select_pack(x[p], k)``. On a CUDA tensor it is one launch for all
    rows, counted on ``topk_select_pack.launches``; on the CPU it selects the
    rows one by one through ``topk_select_pack``."""
    build.check_tensor(x, "x", torch.float32, 2)
    rows, n = x.shape
    if rows < 1:
        raise ValueError("the bank needs at least one row")
    _check_k(n, k)
    if x.device.type == "cpu":
        picks = [topk_select_pack(x[p], k) for p in range(rows)]
        return torch.stack([v for v, _ in picks]), torch.stack([i for _, i in picks])
    return select_launch(x, k)


def _check_sizes(peers: int, k: int, rows: int, n: int) -> None:
    if not 0 <= n < 2**31 or peers * k >= 2**31 or rows >= 2**16:
        raise ValueError(f"n={n}, {peers} x {k} pairs, {rows} rows: out of range (n and pairs "
                         "below 2**31, rows below 2**16)")


def _check_scatter(vbank: torch.Tensor, vals, idx: torch.Tensor, W: torch.Tensor, n: int) -> None:
    build.check_tensor(vbank, "vbank", torch.float32, 2)
    build.check_tensor(idx, "idx", torch.int32, 2)
    build.check_tensor(W, "W", torch.float32, 2)
    peers, k = vbank.shape
    if vals is not None:
        build.check_tensor(vals, "vals", torch.float32, 2)
    same = [t for t in (vals, idx) if t is not None]
    if any(t.shape != vbank.shape for t in same) or W.shape[1] != peers or W.shape[0] < 1 or any(
        t.device != vbank.device for t in (*same, W)
    ):
        raise ValueError(
            f"idx {tuple(idx.shape)}, vals {None if vals is None else tuple(vals.shape)} and W "
            f"{tuple(W.shape)} must be ({peers}, {k}), ({peers}, {k}) and (M >= 1, {peers}) on "
            f"{vbank.device}"
        )
    _check_sizes(peers, k, W.shape[0] + (peers if vals is not None else 0), n)


_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def _scatter_counters(device: torch.device, stream: int, words: int) -> torch.Tensor:
    """The long-row body's counters for ``stream``: zeroed when allocated
    and left zero by every launch (``csrc/topk.cu``); reallocated, zeroed,
    only when a launch needs more words than the stream's hold."""
    key = (device.index, stream)
    if key not in _counters or _counters[key].numel() < words:
        _counters[key] = torch.zeros((max(words, 1),), dtype=torch.int32, device=device)
    return _counters[key]


def scatter_launch(vbank: torch.Tensor, vals, idx: torch.Tensor, W: torch.Tensor, n: int,
                   body: int = 0) -> torch.Tensor:
    """One launch of the scatter over a CUDA bank -> (M + P, n) f32 with own
    rows, else (M, n): the M mixes, then the P own images (the arguments
    of ``topk_scatter_accum_bank``). ``body``: 0 by ``csrc/topk.cu``'s
    rule, 1 the tile body, 2 the long-row body (two kernels, one count)."""
    (peers, k), mixes = vbank.shape, W.shape[0]
    own = vals is not None
    meta = build.on_meta(vbank)
    stream = None if meta else build.cuda_stream(vbank.device)
    out = torch.empty((mixes + (peers if own else 0), n), dtype=torch.float32, device=vbank.device)
    if n == 0:
        return out
    if meta:  # the long-row body's scratch is sized by the built library's rule
        build.charge("topk_scatter_accum", *topk_scatter_cost(peers, k, mixes, n, own))
        return out
    lib = _lib()
    counters = work = None
    with torch.cuda.device(vbank.device):
        if (body or lib.topk_scatter_body(mixes, peers, k, n, int(own))) == 2:
            counters = _scatter_counters(vbank.device, stream.value or 0,
                                         lib.topk_scatter_counter_words(peers, n))
            work = torch.empty((lib.topk_scatter_work_words(peers, k, n, own),), dtype=torch.int32,
                               device=vbank.device)
        err = lib.topk_scatter_launch(
            vbank.data_ptr(), vals.data_ptr() if own else None, idx.data_ptr(), W.data_ptr(),
            out.data_ptr(), mixes, peers, k, n, None if counters is None else counters.data_ptr(),
            None if work is None else work.data_ptr(), body, stream,
        )
    if err:
        if counters is not None:  # a launch cut short may leave them non-zero
            _counters.pop((vbank.device.index, stream.value or 0), None)
        raise RuntimeError(f"topk_scatter_accum kernel launch failed at {mixes} mixes, "
                           f"({peers}, {k}) pairs, n={n}, own rows {own}: cudaError {err}")
    topk_scatter_accum.launches += 1
    build.charge("topk_scatter_accum", *topk_scatter_cost(peers, k, mixes, n, own))
    return out


def topk_scatter_accum_bank(
    vbank: torch.Tensor, vals: Optional[torch.Tensor], idx: torch.Tensor, W: torch.Tensor, n: int
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Every mix and own image of one leaf. vbank (P, k) f32 (the values as
    the wire rounds them), vals (P, k) f32 (unrounded) or None, idx (P, k)
    int32, mixing weights W (M, P) f32 -> (mixes (M, n) f32, own images (P,
    n) f32 or None). Mix r is ``topk_scatter_accum(vbank, idx, W[r], n)``;
    own image p is peer p's entries alone with weight 1, ``0 + vals[p] * 1``
    (not a mix with zero weights, where 0 * inf would make a NaN). On a CUDA
    tensor it is one launch for all rows, counted on
    ``topk_scatter_accum.launches``; on the CPU it computes the rows one by
    one through ``scatter_accum_plain``."""
    _check_scatter(vbank, vals, idx, W, n)
    if vbank.device.type != "cpu":
        out = scatter_launch(vbank, vals, idx, W, n)
        mixes = W.shape[0]
        return out[:mixes], None if vals is None else out[mixes:]
    mixed = torch.stack([scatter_accum_plain(vbank, idx, w, n) for w in W])
    if vals is None:
        return mixed, None
    one = torch.ones((1,), dtype=torch.float32)
    return mixed, torch.stack([scatter_accum_plain(vals[p:p + 1], idx[p:p + 1], one, n)
                               for p in range(vals.shape[0])])


def topk_scatter_accum(
    vals: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, n: int
) -> torch.Tensor:
    """vals (P, k) f32, idx (P, k) int32, mixing weights w (P,) f32 -> dense
    (n,) f32 = sum_p w[p] * scatter(vals[p], idx[p]): the bank with one mix
    and no own rows. Indices within one peer must be distinct, as the
    select gives them."""
    build.check_tensor(vals, "vals", torch.float32, 2)
    build.check_tensor(idx, "idx", torch.int32, 2)
    build.check_tensor(w, "w", torch.float32, 1)
    peers, k = vals.shape
    if idx.shape != vals.shape or tuple(w.shape) != (peers,) or not (
        idx.device == w.device == vals.device
    ):
        raise ValueError(
            f"idx {tuple(idx.shape)} on {idx.device} and w {tuple(w.shape)} on "
            f"{w.device} must be ({peers}, {k}) and ({peers},) on {vals.device}"
        )
    _check_sizes(peers, k, 1, n)
    if vals.device.type == "cpu":
        return scatter_accum_plain(vals, idx, w, n)
    return scatter_launch(vals, None, idx, w.view(1, peers), n)[0]


topk_scatter_accum.launches = 0
