// Top-k select-and-pack / scatter-accumulate for Hopper (sm_90a), bound
// with a plain C interface and loaded through ctypes by
// repro_torch/kernels/topk.py.
//
// Replaces the Pallas TPU kernels repro/kernels/topk.py:_select_kernel
// (wrapper topk_select_pack) and :_scatter_kernel (wrapper
// topk_scatter_accum).
//
// select: the Pallas kernel holds the whole leaf in one VMEM block and runs
// a 64-step bisection on the magnitude threshold, each step a compare and
// count over the leaf, from lo = 0 and hi = max|x| * f32(1 + 1e-6) +
// f32(1e-30). Its output is kept bit for bit here, but not its 64 passes:
// count(|x| >= mid) >= k holds exactly when mid <= T, T the k-th largest
// |x| counted with multiplicity, so the bisection's whole path is a
// function of max|x| and T alone. The kernel finds both exactly and then
// replays the 64 steps in registers without reading x:
//   1. radix pass 1: a shared-memory histogram of bits 30..20 of the bit
//      patterns of |x| (non-negative floats, denormals and +inf included,
//      order as their bit patterns), and the bit-pattern max of |x|: an
//      integer max, so a NaN (above +inf) propagates as torch.max does;
//      every block then scans the histogram from the top to the digit that
//      holds rank k and the rank left inside it;
//   2. radix pass 2: the same over bits 19..9 of the entries whose top
//      digit matched; 3. radix pass 3: bits 8..0. T's bits are now exact;
//   4. one thread replays the 64 steps, mid = 0.5 * (lo + hi), big = mid <=
//      T, all 64 of them (an early exit at mid == hi would break hi = T =
//      +inf); with a NaN max, mid is NaN, big never holds, and nothing is
//      selected, as in the Pallas kernel;
//   5. the tier pass counts the "sure" (|x| >= hi) and "edge" (lo <= |x| <
//      hi) entries of each warp's contiguous segment, ranks the segments
//      (across the grid, after a grid sync), then packs each segment in
//      index order with warp scans alone: every sure entry at its rank
//      (slots past k dropped, as the Pallas kernel's padded banks drop
//      them when more than k entries are +inf), then the first k - n_sure
//      edge entries. Every slot left unfilled gets value 0 and index 0, as
//      the Pallas kernel's zeroed banks do.
// That is 5 reads of x (3 radix passes, the tier count, the pack) against
// the Pallas algorithm's 66.
//
// Two bodies, one launch for all rows of a (rows, n) bank:
// - rows of at most kSmallRowMax entries: one 1024-thread block per row, a
//   normal launch (no grid sync, no scratch in device memory: the
//   histograms live in shared memory). The row is read from device memory
//   once; the later passes find it in L2. (Staging the row in shared
//   memory where it fits measured slower on the card, so the kernel does
//   not.) kSmallRowMax = 90,112 is where the two bodies cross at a (4, n)
//   bank, the device step's, on an NVIDIA H100 80GB HBM3 at 700 W
//   (chip_smoke.py's body sweep; PERF.md, section 6). A single row (a
//   host-path publish) crosses lower, near 12k entries; that path is
//   host-bound, so one threshold serves both.
// - longer rows: a cooperative grid (4 resident 256-thread blocks an SM,
//   registers capped to fit them, each block owning one contiguous chunk
//   of the row) walks the rows one after another. Each radix pass merges
//   the blocks' shared-memory histograms into device memory (atomicAdd of
//   the non-zero bins), and a grid sync separates the passes: 4 grid syncs
//   per row (after each radix pass and after the tier count). No memset:
//   each histogram is zeroed inside the kernel before the grid sync that
//   precedes its pass, and the first pass's histogram and the max word are
//   zeroed after their last reader, so the scratch is zero again when the
//   kernel ends (the wrapper allocates it zeroed once per device and
//   stream).
// In both, each thread loads two runs of four entries before it uses any,
// so that enough loads are in flight to cover the memory's latency.
// Bound: bytes, 4 B per element read plus 8 B per selected entry written.
//
// scatter: one launch computes every row of a leaf's bank: the mixes,
// row r = sum_p w[r, p] * scatter(vbank[p], idx[p]), and (EF) each peer's
// own image, 0 + scatter(vals[p], idx[p]) * 1. Each output element is
// 0 + c_p0 + c_p1 + ... over the peers that hit it, in peer order, every
// product rounded before its add: the reference's sequence bit for bit,
// with no atomics on the output and no read of it. Within one peer the
// select gives distinct indices, so no two threads add into one element
// (a NaN leaf's payload, k slots of value 0 at index 0, adds +0 or NaN k
// times, which any interleaving leaves as one add). Indices outside [0, n)
// are dropped, as in the Pallas kernel. Two bodies, both writing each
// output tile of kTile = 8192 floats once from shared memory:
// - the tile body (a normal launch): one block per (tile, row) zeroes its
//   tile, streams the row's pairs peer by peer (a barrier between peers)
//   adding those that fall in the tile, and writes it with 16-byte stores.
//   Every block reads all of its row's pairs, so it serves rows where that
//   stays cheap (scatter_body): a row of one tile, or one where a block
//   reads peers x k <= kTilePairsMax = 24,576 pairs (past that its
//   dependent loads outlast the long-row body) and all blocks together
//   read tiles x (mixes + (own rows ? 1 : 0)) x peers x k <= 2^23 + a
//   quarter of the output elements (past that the reads, from L2, outlast
//   the long-row body's fixed cost of about 0.012 ms and its slower
//   write). Both limits are measured on an NVIDIA H100 80GB HBM3 at 700 W
//   (chip_smoke.py's body sweep; PERF.md, section 6): over k = 1 %, 0.1 %
//   and 0.01 % of n, n from 8,192 to 16,777,216, (1 mix + 4 own rows)
//   banks, P = 1 rows and (4 ring mixes + 4 own rows) banks, the rule picks
//   the faster body at every point but one, where it is 10 % slower. The
//   main path's rows all take the tile body.
// - the long-row body: a cooperative grid sends each pair to its bucket
//   (tile, peer): a count (warp-aggregated atomics), a grid sync, an
//   exclusive scan of the counts, a grid sync, the pairs placed; then a
//   second, normal launch runs one block per (tile, row) as the tile body,
//   reading only that tile's buckets. Its counters are zeroed inside the
//   launches that read them last, so no memset runs.
// The earlier cooperative kernel (zero all n, then a grid sync and a
// read-modify-write of out through L2 per peer) spent at fc2/w, P = 4,
// 0.0252 of its 0.0558 ms on the zero pass and about 0.007 ms on each
// peer; for the device step's small leaves, two launches a leaf (the mix
// and a P = 1 scatter of the own images) of 4-17 us each.
// Bound: bytes, (4 + 4) B per (wire value, index) read, 4 B per unrounded
// value read for own rows, 4 B per weight, 4 B per output element written.
//
// Both use __fmul_rn / __fadd_rn where the reference rounds a product
// before adding it, so nvcc cannot contract the pair into one FMA. No fast
// math and no flush to zero: denormal magnitudes compare exactly.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;      // a block of the select's grid body and of the scatter
constexpr int kRowThreads = 1024;  // a block of the one-block body
constexpr long long kSmallRowMax = 90112;
constexpr int kMaxDevices = 64;
// the scatter
constexpr int kTile = 8192;  // outputs of one tile, in shared memory
// the tile body's limits (scatter_body): the pairs one block reads, and
// the pairs all blocks read beyond a quarter of the output elements
constexpr long long kTilePairsMax = 3LL * kTile;
constexpr long long kTileReadsBase = 1LL << 23;
constexpr int kScatterUnroll = 4;  // pairs a thread loads before it adds any
constexpr int kMaxLongGrid = 1024;  // blocks of the long-row body, at most
constexpr int kBisectSteps = 64;
constexpr int kUnroll = 2;     // runs of four entries a thread loads per step
constexpr int kGridBlocksPerSm = 4;  // the grid body's registers are capped for 4 blocks an SM
// radix digits of the 31-bit pattern of |x|: bits 30..20, 19..9, 8..0
constexpr int kBins = 2048;  // passes 1 and 2
constexpr int kBins3 = 512;  // pass 3
// scratch words of the grid body: the three merged histograms, the max
// bits, then the per-block sure counts and edge counts
constexpr int kHist1 = 0;
constexpr int kHist2 = kHist1 + kBins;
constexpr int kHist3 = kHist2 + kBins;
constexpr int kMaxWord = kHist3 + kBins3;
constexpr int kScratchHead = kMaxWord + 1;

__device__ __forceinline__ unsigned mag_bits(float v) { return __float_as_uint(fabsf(v)); }

template <int NT>
__device__ __forceinline__ unsigned block_sum(unsigned v, unsigned* red) {
  v = __reduce_add_sync(0xffffffffu, v);
  __syncthreads();  // red may still be read from the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned total = 0;
  for (int i = 0; i < NT / 32; ++i) total += red[i];
  return total;
}

template <int NT>
__device__ __forceinline__ unsigned block_max(unsigned v, unsigned* red) {
  v = __reduce_max_sync(0xffffffffu, v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned m = 0;
  for (int i = 0; i < NT / 32; ++i) m = max(m, red[i]);
  return m;
}

// Exclusive scan of v over the block; *total gets the block's sum.
template <int NT>
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v, unsigned* red,
                                                         unsigned* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  __syncthreads();  // red may still be read from the previous call
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  unsigned before = 0, sum = 0;
  for (int i = 0; i < NT / 32; ++i) {
    if (i < warp) before += red[i];
    sum += red[i];
  }
  *total = sum;
  return before + incl - v;
}

// Entries i .. i + 3 of x, those at or past end read as 0 (one 16-byte load
// where vec says x + i is 16-byte aligned).
__device__ __forceinline__ float4 load4(const float* x, long long i, long long end, bool vec) {
  if (vec && i + 3 < end) return *reinterpret_cast<const float4*>(x + i);
  float4 v;
  v.x = i < end ? x[i] : 0.0f;
  v.y = i + 1 < end ? x[i + 1] : 0.0f;
  v.z = i + 2 < end ? x[i + 2] : 0.0f;
  v.w = i + 3 < end ? x[i + 3] : 0.0f;
  return v;
}

// f(x[i]) for every i in [beg, end): each thread takes kUnroll runs of
// four consecutive entries per step, all loaded before any is used.
template <int NT, typename F>
__device__ __forceinline__ void for_each4(const float* x, long long beg, long long end, F f) {
  const bool vec = (reinterpret_cast<uintptr_t>(x + beg) & 15) == 0;
  for (long long t0 = beg; t0 < end; t0 += 4 * NT * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = load4(x, t0 + 4 * static_cast<long long>(threadIdx.x + u * NT), end, vec);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = t0 + 4 * static_cast<long long>(threadIdx.x + u * NT);
      if (i + 3 < end) {  // the common case, with no test per entry
        f(v[u].x);
        f(v[u].y);
        f(v[u].z);
        f(v[u].w);
      } else {
        if (i < end) f(v[u].x);
        if (i + 1 < end) f(v[u].y);
        if (i + 2 < end) f(v[u].z);
      }
    }
  }
}

// Adds the entries of x[beg, end) whose bits >> match_shift equal match to
// hist[(bits >> shift) & mask] (hist zeroed by the caller); returns this
// thread's max of the bits seen.
template <int NT>
__device__ __forceinline__ unsigned radix_pass(const float* x, long long beg, long long end,
                                               unsigned* hist, int match_shift, unsigned match,
                                               int shift, unsigned mask) {
  unsigned mx = 0;
  for_each4<NT>(x, beg, end, [&](float v) {
    const unsigned b = mag_bits(v);
    if ((b >> match_shift) == match) atomicAdd(&hist[(b >> shift) & mask], 1u);
    mx = max(mx, b);
  });
  return mx;
}

// The digit (bin) of hist that holds rank `rank` (1 = the largest) counted
// from the top, and the rank left inside it: res[0], res[1] for every
// thread of the block. hist lies in device memory (kGlobal, read from L2,
// where the blocks' atomics went) or in shared memory.
template <int NT, int NBINS, bool kGlobal>
__device__ __forceinline__ void find_digit(const unsigned* hist, unsigned rank, unsigned* red,
                                           unsigned* res) {
  constexpr int kPer = (NBINS + NT - 1) / NT;
  unsigned c[kPer];
  unsigned s = 0;
  for (int j = 0; j < kPer; ++j) {
    const int t = threadIdx.x * kPer + j;  // t-th bin from the top
    c[j] = 0;
    if (t < NBINS) {
      if constexpr (kGlobal) {
        c[j] = __ldcg(&hist[NBINS - 1 - t]);
      } else {
        c[j] = hist[NBINS - 1 - t];
      }
    }
    s += c[j];
  }
  unsigned total;
  unsigned above = block_exclusive_scan<NT>(s, red, &total);
  if (above < rank && rank <= above + s) {
    for (int j = 0; j < kPer; ++j) {
      if (above + c[j] >= rank) {
        res[0] = NBINS - 1 - (threadIdx.x * kPer + j);
        res[1] = rank - above;
        break;
      }
      above += c[j];
    }
  }
  __syncthreads();
}

// The Pallas kernel's 64-step bracket from max|x| and T (as bit patterns).
__device__ __forceinline__ void replay_bracket(unsigned max_bits, unsigned t_bits, float* lo_out,
                                               float* hi_out) {
  const float t = __uint_as_float(t_bits);
  float lo = 0.0f;
  float hi = __fadd_rn(__fmul_rn(__uint_as_float(max_bits), static_cast<float>(1.0 + 1e-6)),
                       static_cast<float>(1e-30));
  for (int step = 0; step < kBisectSteps; ++step) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const bool big = mid <= t;
    lo = big ? mid : lo;
    hi = big ? hi : mid;
  }
  *lo_out = lo;
  *hi_out = hi;
}

// Bit j of *sure / *edge: entry i + j (below end) is sure (|x| >= hi) / on
// the edge (lo <= |x| < hi).
__device__ __forceinline__ void tier_bits(float4 v, long long i, long long end, float lo,
                                          float hi, unsigned* sure, unsigned* edge) {
  const float m[4] = {fabsf(v.x), fabsf(v.y), fabsf(v.z), fabsf(v.w)};
  unsigned s = 0, e = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = i + j < end;
    s |= static_cast<unsigned>(in && m[j] >= hi) << j;
    e |= static_cast<unsigned>(in && m[j] >= lo && m[j] < hi) << j;
  }
  *sure = s;
  *edge = e;
}

// The tier pass splits the block's range [beg, end) into one contiguous
// segment per warp (whole steps of 256 entries: two runs of four a lane),
// so that each warp counts and then packs its own entries in index order
// with warp shuffles alone, never waiting for the block.
template <int NT>
__device__ __forceinline__ void warp_segment(long long beg, long long end, long long* wbeg,
                                             long long* wend) {
  constexpr int kWarps = NT / 32;
  const long long seg = ((end - beg + kWarps - 1) / kWarps + 255) / 256 * 256;
  *wbeg = min(end, beg + seg * (threadIdx.x >> 5));
  *wend = min(end, *wbeg + seg);
}

// Each warp's sure and edge counts over its segment: wsure[w], wedge[w].
template <int NT>
__device__ __forceinline__ void tier_count(const float* x, long long beg, long long end, float lo,
                                           float hi, unsigned* wsure, unsigned* wedge) {
  long long wbeg, wend;
  warp_segment<NT>(beg, end, &wbeg, &wend);
  const bool vec = (reinterpret_cast<uintptr_t>(x + wbeg) & 15) == 0;
  const int lane = threadIdx.x & 31;
  unsigned s = 0, e = 0;
  for (long long t0 = wbeg; t0 < wend; t0 += 256) {
    const float4 a = load4(x, t0 + 4 * lane, wend, vec);
    const float4 b = load4(x, t0 + 128 + 4 * lane, wend, vec);
    unsigned sa, ea, sb, eb;
    tier_bits(a, t0 + 4 * lane, wend, lo, hi, &sa, &ea);
    tier_bits(b, t0 + 128 + 4 * lane, wend, lo, hi, &sb, &eb);
    s += __popc(sa) + __popc(sb);
    e += __popc(ea) + __popc(eb);
  }
  s = __reduce_add_sync(0xffffffffu, s);
  e = __reduce_add_sync(0xffffffffu, e);
  if (lane == 0) {
    wsure[threadIdx.x >> 5] = s;
    wedge[threadIdx.x >> 5] = e;
  }
}

// Packs each warp's segment in index order: the sure entries from rank
// s_off, the edge entries from rank e_off (slot n_sure + rank while below
// k), s_off and e_off being the ranks of the block's first entries and
// wsure, wedge the warps' counts (tier_count).
template <int NT>
__device__ __forceinline__ void tier_pack(const float* x, long long beg, long long end, float lo,
                                          float hi, long long s_off, long long e_off,
                                          const unsigned* wsure, const unsigned* wedge,
                                          long long n_sure, long long k, float* out_v,
                                          int* out_i) {
  long long wbeg, wend;
  warp_segment<NT>(beg, end, &wbeg, &wend);
  const bool vec = (reinterpret_cast<uintptr_t>(x + wbeg) & 15) == 0;
  const int lane = threadIdx.x & 31;
  for (int w = 0; w < static_cast<int>(threadIdx.x >> 5); ++w) {
    s_off += wsure[w];
    e_off += wedge[w];
  }
  const long long fill = k - n_sure;
  for (long long t0 = wbeg; t0 < wend; t0 += 256) {
    const float4 run[2] = {load4(x, t0 + 4 * lane, wend, vec),
                           load4(x, t0 + 128 + 4 * lane, wend, vec)};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const long long i = t0 + 128 * u + 4 * lane;
      unsigned sure, edge;
      tier_bits(run[u], i, wend, lo, hi, &sure, &edge);
      // one warp scan for both tiers: sure in the low 16 bits, edge in the high
      const unsigned mine = static_cast<unsigned>(__popc(sure)) |
                            (static_cast<unsigned>(__popc(edge)) << 16);
      if (!__any_sync(0xffffffffu, mine)) continue;
      unsigned incl = mine;
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const unsigned total = __shfl_sync(0xffffffffu, incl, 31);
      if (mine) {
        const float v[4] = {run[u].x, run[u].y, run[u].z, run[u].w};
        long long rs = s_off + ((incl - mine) & 0xffffu), re = e_off + ((incl - mine) >> 16);
        for (int j = 0; j < 4; ++j) {
          long long slot = -1;
          if (sure >> j & 1) {
            slot = rs++;
          } else if (edge >> j & 1) {
            const long long er = re++;
            if (er < fill) slot = n_sure + er;
          }
          if (slot >= 0 && slot < k) {
            out_v[slot] = v[j];
            out_i[slot] = static_cast<int>(i + j);
          }
        }
      }
      s_off += total & 0xffffu;
      e_off += total >> 16;
    }
  }
}

// Slots the pack fills; fewer than k only on a leaf holding a NaN, whose
// bracket keeps no entry (count(|x| >= lo) >= k holds on any other leaf).
__device__ __forceinline__ long long packed_slots(long long n_sure, long long n_edge, long long k) {
  return min(n_sure, k) + max(0LL, min(k - n_sure, n_edge));
}

// One block per row.
__global__ void __launch_bounds__(kRowThreads)
select_row_kernel(const float* __restrict__ x, long long n, long long k, float* __restrict__ out_v,
                  int* __restrict__ out_i) {
  __shared__ unsigned hist[kBins];
  __shared__ unsigned red[kRowThreads / 32];
  __shared__ unsigned wsure[kRowThreads / 32], wedge[kRowThreads / 32];
  __shared__ unsigned res[2];
  __shared__ float bracket[2];
  const float* xr = x + static_cast<long long>(blockIdx.x) * n;
  out_v += static_cast<long long>(blockIdx.x) * k;
  out_i += static_cast<long long>(blockIdx.x) * k;

  // 1. bits 30..20 and the max
  for (int b = threadIdx.x; b < kBins; b += kRowThreads) hist[b] = 0;
  __syncthreads();
  unsigned mx = 0;
  for_each4<kRowThreads>(xr, 0, n, [&](float v) {
    const unsigned b = mag_bits(v);
    atomicAdd(&hist[b >> 20], 1u);
    mx = max(mx, b);
  });
  const unsigned max_bits = block_max<kRowThreads>(mx, red);
  find_digit<kRowThreads, kBins, false>(hist, static_cast<unsigned>(k), red, res);
  const unsigned d1 = res[0];
  // 2. bits 19..9 of the entries in digit d1
  for (int b = threadIdx.x; b < kBins; b += kRowThreads) hist[b] = 0;
  __syncthreads();
  radix_pass<kRowThreads>(xr, 0, n, hist, 20, d1, 9, kBins - 1);
  __syncthreads();
  find_digit<kRowThreads, kBins, false>(hist, res[1], red, res);
  const unsigned p2 = d1 << 11 | res[0];
  // 3. bits 8..0
  for (int b = threadIdx.x; b < kBins3; b += kRowThreads) hist[b] = 0;
  __syncthreads();
  radix_pass<kRowThreads>(xr, 0, n, hist, 9, p2, 0, kBins3 - 1);
  __syncthreads();
  find_digit<kRowThreads, kBins3, false>(hist, res[1], red, res);
  // 4. the bracket
  if (threadIdx.x == 0) replay_bracket(max_bits, p2 << 9 | res[0], &bracket[0], &bracket[1]);
  __syncthreads();
  const float lo = bracket[0], hi = bracket[1];
  // 5. the two tiers
  tier_count<kRowThreads>(xr, 0, n, lo, hi, wsure, wedge);
  __syncthreads();
  long long n_sure = 0, n_edge = 0;
  for (int w = 0; w < kRowThreads / 32; ++w) {
    n_sure += wsure[w];
    n_edge += wedge[w];
  }
  tier_pack<kRowThreads>(xr, 0, n, lo, hi, 0, 0, wsure, wedge, n_sure, k, out_v, out_i);
  for (long long s = packed_slots(n_sure, n_edge, k) + threadIdx.x; s < k; s += kRowThreads) {
    out_v[s] = 0.0f;
    out_i[s] = 0;
  }
}

// Merges a block's shared-memory histogram into device memory.
template <int NBINS>
__device__ __forceinline__ void merge_hist(const unsigned* hist, unsigned* g_hist) {
  __syncthreads();
  for (int b = threadIdx.x; b < NBINS; b += kThreads) {
    if (hist[b]) atomicAdd(&g_hist[b], hist[b]);
  }
}

// The radix pass of the grid body over this block's chunk.
template <int NBINS>
__device__ __forceinline__ unsigned grid_radix_pass(const float* x, long long beg, long long end,
                                                    unsigned* hist, unsigned* g_hist,
                                                    int match_shift, unsigned match, int shift) {
  for (int b = threadIdx.x; b < NBINS; b += kThreads) hist[b] = 0;
  __syncthreads();
  const unsigned mx = radix_pass<kThreads>(x, beg, end, hist, match_shift, match, shift, NBINS - 1);
  merge_hist<NBINS>(hist, g_hist);
  return mx;
}

// Long rows: a cooperative grid walks the rows in order.
__global__ void __launch_bounds__(kThreads, kGridBlocksPerSm)
select_grid_kernel(const float* __restrict__ x, int rows, long long n, long long k,
                   float* __restrict__ out_v, int* __restrict__ out_i,
                   unsigned* __restrict__ scratch) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned hist[kBins];
  __shared__ unsigned red[kThreads / 32];
  __shared__ unsigned wsure[kThreads / 32], wedge[kThreads / 32];
  __shared__ unsigned res[2];
  __shared__ float bracket[2];
  unsigned* g_hist1 = scratch + kHist1;
  unsigned* g_hist2 = scratch + kHist2;
  unsigned* g_hist3 = scratch + kHist3;
  unsigned* g_max = scratch + kMaxWord;
  unsigned* sure_cnt = scratch + kScratchHead;
  unsigned* edge_cnt = sure_cnt + gridDim.x;
  // chunks of a multiple of 4 entries, so that 16-byte loads stay aligned
  const long long chunk = ((n + gridDim.x - 1) / gridDim.x + 3) / 4 * 4;
  const long long beg = min(n, chunk * blockIdx.x);
  const long long end = min(n, beg + chunk);
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kThreads;

  for (int row = 0; row < rows; ++row) {
    const float* xr = x + static_cast<long long>(row) * n;
    float* ov = out_v + static_cast<long long>(row) * k;
    int* oi = out_i + static_cast<long long>(row) * k;
    // 1. bits 30..20 and the max. Passes 2 and 3 add into hist2 and hist3
    // only after the next grid sync, and their last readers (the previous
    // row's) are past the previous row's last grid sync.
    if (blockIdx.x == 0) {
      for (int b = threadIdx.x; b < kBins; b += kThreads) g_hist2[b] = 0;
      for (int b = threadIdx.x; b < kBins3; b += kThreads) g_hist3[b] = 0;
    }
    unsigned mx = grid_radix_pass<kBins>(xr, beg, end, hist, g_hist1, 31, 0, 20);
    mx = block_max<kThreads>(mx, red);
    if (threadIdx.x == 0 && mx) atomicMax(g_max, mx);
    grid.sync();
    const unsigned max_bits = __ldcg(g_max);
    find_digit<kThreads, kBins, true>(g_hist1, static_cast<unsigned>(k), red, res);
    const unsigned d1 = res[0];
    // 2. bits 19..9
    grid_radix_pass<kBins>(xr, beg, end, hist, g_hist2, 20, d1, 9);
    grid.sync();
    // every block has read hist1 and the max: zero them for the next row
    // (or launch) before the next grid sync
    if (blockIdx.x == 0) {
      for (int b = threadIdx.x; b < kBins; b += kThreads) g_hist1[b] = 0;
      if (threadIdx.x == 0) *g_max = 0;
    }
    find_digit<kThreads, kBins, true>(g_hist2, res[1], red, res);
    const unsigned p2 = d1 << 11 | res[0];
    // 3. bits 8..0
    grid_radix_pass<kBins3>(xr, beg, end, hist, g_hist3, 9, p2, 0);
    grid.sync();
    find_digit<kThreads, kBins3, true>(g_hist3, res[1], red, res);
    // 4. the bracket, in every block alike
    if (threadIdx.x == 0) replay_bracket(max_bits, p2 << 9 | res[0], &bracket[0], &bracket[1]);
    __syncthreads();
    const float lo = bracket[0], hi = bracket[1];
    // 5. the two tiers, ranked in index order across the grid
    tier_count<kThreads>(xr, beg, end, lo, hi, wsure, wedge);
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned ns = 0, ne = 0;
      for (int w = 0; w < kThreads / 32; ++w) {
        ns += wsure[w];
        ne += wedge[w];
      }
      sure_cnt[blockIdx.x] = ns;
      edge_cnt[blockIdx.x] = ne;
    }
    grid.sync();
    unsigned s_before = 0, e_before = 0, s_all = 0, e_all = 0;  // n < 2^31: 32 bits hold them
    for (unsigned b = threadIdx.x; b < gridDim.x; b += kThreads) {
      const unsigned sc = __ldcg(&sure_cnt[b]);
      const unsigned ec = __ldcg(&edge_cnt[b]);
      s_all += sc;
      e_all += ec;
      if (b < blockIdx.x) {
        s_before += sc;
        e_before += ec;
      }
    }
    s_before = block_sum<kThreads>(s_before, red);
    e_before = block_sum<kThreads>(e_before, red);
    const long long n_sure = block_sum<kThreads>(s_all, red);
    const long long n_edge = block_sum<kThreads>(e_all, red);
    tier_pack<kThreads>(xr, beg, end, lo, hi, s_before, e_before, wsure, wedge, n_sure, k, ov,
                        oi);
    for (long long s = packed_slots(n_sure, n_edge, k) + tid; s < k; s += nthreads) {
      ov[s] = 0.0f;
      oi[s] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// scatter
// ---------------------------------------------------------------------------

// A bank of output rows, each a sum over peers of scatter(values, idx[p]) *
// weight: rows 0 .. mixes-1 are mixes (values vbank, weights w[r, p], every
// peer); rows mixes .. mixes+peers-1, when vals is set, are the peers' own
// images (row mixes + p: vals[p] alone, weight 1).
struct ScatterBank {
  const float* vbank;  // (peers, k): the values the mixes add
  const float* vals;   // (peers, k): the values of the own rows, or null (no own rows)
  const int* idx;      // (peers, k)
  const float* w;      // (mixes, peers)
  float* out;          // (rows, n)
  int mixes;
  int peers;
  long long k;
  long long n;
};

__device__ __forceinline__ int bank_rows(const ScatterBank& b) {
  return b.mixes + (b.vals ? b.peers : 0);
}

// The peers [*p0, *p1) that row r adds, in order.
__device__ __forceinline__ void row_peers(const ScatterBank& b, int r, int* p0, int* p1) {
  *p0 = r < b.mixes ? 0 : r - b.mixes;
  *p1 = r < b.mixes ? b.peers : *p0 + 1;
}

__device__ __forceinline__ float row_weight(const ScatterBank& b, int r, int p) {
  return r < b.mixes ? b.w[static_cast<long long>(r) * b.peers + p] : 1.0f;
}

// acc[0 .. len) = 0 (acc 16-byte aligned, kTile floats).
__device__ __forceinline__ void zero_tile(float* acc, int len) {
  float4* a4 = reinterpret_cast<float4*>(acc);
  for (int i = threadIdx.x; i < (len + 3) / 4; i += kThreads) a4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// o[0 .. len) = acc[0 .. len): 16-byte stores from the first 16-byte
// aligned element of o on (the rows of an (rows, n) output with n % 4 != 0
// start at other alignments).
__device__ __forceinline__ void store_tile(const float* acc, float* o, int len) {
  const int peel = min(len, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(o) & 15)) & 15) / 4);
  const int n4 = (len - peel) / 4;
  for (int i = threadIdx.x; i < peel; i += kThreads) o[i] = acc[i];
  float4* o4 = reinterpret_cast<float4*>(o + peel);
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const float* a = acc + peel + 4 * i;
    o4[i] = make_float4(a[0], a[1], a[2], a[3]);
  }
  for (int i = peel + 4 * n4 + threadIdx.x; i < len; i += kThreads) o[i] = acc[i];
}

// acc[t - lo] += val[e] * w for the entries e in [e0, e1) whose index t =
// idx[e] lies in [lo, lo + len) (indices outside [0, n) fall outside every
// tile), each thread loading kScatterUnroll entries before it adds any.
// The entries' indices are distinct (one peer's), so no two threads add
// into one element.
__device__ __forceinline__ void add_entries(float* acc, const int* idx, const float* val,
                                            long long e0, long long e1, long long lo, int len,
                                            float w) {
  for (long long j0 = e0; j0 < e1; j0 += kThreads * kScatterUnroll) {
    int t[kScatterUnroll];
    float v[kScatterUnroll];
#pragma unroll
    for (int u = 0; u < kScatterUnroll; ++u) {
      const long long j = j0 + threadIdx.x + u * kThreads;
      t[u] = j < e1 ? __ldg(idx + j) : -1;
      v[u] = j < e1 ? __ldg(val + j) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kScatterUnroll; ++u) {
      const long long d = t[u] - lo;
      if (d >= 0 && d < len) acc[d] = __fadd_rn(acc[d], __fmul_rn(v[u], w));
    }
  }
}

// The tile body: one block per (tile of kTile outputs, row). The block
// zeroes its tile in shared memory, streams each of the row's peers' k
// pairs in the reference's peer order (a barrier between peers) and adds
// those whose index falls in the tile, then writes the tile once.
__global__ void __launch_bounds__(kThreads)
scatter_tile_kernel(ScatterBank b) {
  __shared__ __align__(16) float acc[kTile];
  const long long lo = static_cast<long long>(blockIdx.x) * kTile;
  const int len = static_cast<int>(min(static_cast<long long>(kTile), b.n - lo));
  const int r = blockIdx.y;
  int p0, p1;
  row_peers(b, r, &p0, &p1);
  zero_tile(acc, len);
  __syncthreads();
  for (int p = p0; p < p1; ++p) {
    add_entries(acc, b.idx, r < b.mixes ? b.vbank : b.vals, p * b.k, (p + 1) * b.k, lo, len,
                row_weight(b, r, p));
    __syncthreads();  // this peer's adds land before the next peer's
  }
  store_tile(acc, b.out + static_cast<long long>(r) * b.n + lo, len);
}

// Exclusive prefix sums of src[0 .. count) into dst, each src entry set to
// zero once read when `clear`; returns the total. Every thread of the block
// calls it.
__device__ __forceinline__ unsigned block_scan_into(unsigned* src, unsigned* dst, unsigned count,
                                                    bool clear, unsigned* red) {
  unsigned carry = 0;
  for (unsigned c = 0; c < count; c += kThreads) {
    const unsigned i = c + threadIdx.x;
    const unsigned x = i < count ? __ldcg(&src[i]) : 0u;
    if (clear && i < count) src[i] = 0;
    unsigned total;
    const unsigned before = block_exclusive_scan<kThreads>(x, red, &total);
    if (i < count) dst[i] = carry + before;
    carry += total;
  }
  return carry;
}

// The pairs of one warp step of the long-row body: lane l's kScatterUnroll
// pairs e = e0 + l + 32 u of the flattened (peers, k) bank, their indices
// and buckets (tile, peer); live where the index lies in [0, n) (and e
// below peers x k).
struct PairRun {
  unsigned e[kScatterUnroll];
  int t[kScatterUnroll];
  unsigned key[kScatterUnroll];
  bool live[kScatterUnroll];
};

__device__ __forceinline__ PairRun load_pairs(const ScatterBank& b, unsigned e0) {
  const unsigned pk = static_cast<unsigned>(b.peers * b.k);
  PairRun run;
#pragma unroll
  for (int u = 0; u < kScatterUnroll; ++u) {
    run.e[u] = e0 + (threadIdx.x & 31) + 32 * u;
    run.t[u] = run.e[u] < pk ? __ldg(b.idx + run.e[u]) : -1;
  }
#pragma unroll
  for (int u = 0; u < kScatterUnroll; ++u) {
    run.live[u] = run.t[u] >= 0 && run.t[u] < b.n;
    const unsigned p = run.e[u] / static_cast<unsigned>(b.k);
    run.key[u] = run.live[u] ? static_cast<unsigned>(run.t[u] / kTile) * b.peers + p : 0u;
  }
  return run;
}

// f(run) for every warp step over the bank's pairs (warp-uniform trip
// counts: every lane of a warp calls f together).
template <typename F>
__device__ __forceinline__ void for_each_run(const ScatterBank& b, F f) {
  constexpr unsigned kStep = 32 * kScatterUnroll;
  const unsigned pk = static_cast<unsigned>(b.peers * b.k);
  const unsigned warp = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const unsigned warps = gridDim.x * kThreads / 32;
  for (unsigned e0 = warp * kStep; e0 < pk; e0 += warps * kStep) f(load_pairs(b, e0));
}

// The leader of each group of lanes that share a live key; `same` the
// group's lanes.
__device__ __forceinline__ bool group_leader(unsigned key, bool live, unsigned* same) {
  *same = __match_any_sync(0xffffffffu, live ? key : 0xffffffffu);
  return live && (threadIdx.x & 31) == __ffs(*same) - 1;
}

// The long-row body's scratch: `counters` (2 nb words, zero at entry and
// left zero) and `work` (no initial value), nb = tiles x peers buckets.
struct Buckets {
  unsigned* cnt;     // nb: pairs a bucket holds
  unsigned* fill;    // nb: pairs placed so far
  unsigned* off;     // nb: a bucket's first entry within its slice
  unsigned* part;    // kMaxLongGrid: a slice's pairs
  unsigned* starts;  // nb + 1: a bucket's first entry; starts[nb] = every pair
  int* idx;          // peers x k: the entries, bucket after bucket
  float* v;          // their wire values
  float* u;          // their unrounded values (own rows only)
};

__device__ __forceinline__ Buckets buckets(const ScatterBank& b, unsigned* counters,
                                          unsigned* work) {
  const unsigned nb = static_cast<unsigned>((b.n + kTile - 1) / kTile) * b.peers;
  const long long pk = b.peers * b.k;
  Buckets s;
  s.cnt = counters;
  s.fill = counters + nb;
  s.off = work;
  s.part = s.off + nb;
  s.starts = s.part + kMaxLongGrid;
  s.idx = reinterpret_cast<int*>(s.starts + nb + 1);
  s.v = reinterpret_cast<float*>(s.idx + pk);
  s.u = s.v + pk;
  return s;
}

// Steps 1-3 of the long-row body, a cooperative grid:
//   1. count the pairs of each bucket (tile, peer), one atomic per bucket
//      a warp step meets;
//   2. grid sync; each block scans its slice of the counts (offsets within
//      the slice, the slice's total) and zeroes them;
//   3. grid sync; each block scans the slices' totals, writes its slice's
//      bucket starts, and sends each pair to its bucket (index, wire value
//      and, with own rows, unrounded value), its slot from a second
//      counter.
__global__ void __launch_bounds__(kThreads)
scatter_bucket_kernel(ScatterBank b, unsigned* __restrict__ counters, unsigned* __restrict__ work) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned base[kMaxLongGrid];  // the slices' offsets
  __shared__ unsigned red[kThreads / 32];
  const Buckets s = buckets(b, counters, work);
  const unsigned nb = static_cast<unsigned>((b.n + kTile - 1) / kTile) * b.peers;
  const unsigned slice = (nb + gridDim.x - 1) / gridDim.x;
  const unsigned s0 = min(nb, blockIdx.x * slice), s1 = min(nb, s0 + slice);
  // 1.
  for_each_run(b, [&](const PairRun& run) {
#pragma unroll
    for (int u = 0; u < kScatterUnroll; ++u) {
      unsigned same;
      if (group_leader(run.key[u], run.live[u], &same)) atomicAdd(&s.cnt[run.key[u]], __popc(same));
    }
  });
  grid.sync();
  // 2.
  const unsigned slice_total = block_scan_into(s.cnt + s0, s.off + s0, s1 - s0, true, red);
  if (threadIdx.x == 0) s.part[blockIdx.x] = slice_total;
  grid.sync();
  // 3.
  const unsigned total = block_scan_into(s.part, base, gridDim.x, false, red);
  __syncthreads();
  for (unsigned i = s0 + threadIdx.x; i < s1; i += kThreads) {
    s.starts[i] = __ldcg(&s.off[i]) + base[blockIdx.x];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) s.starts[nb] = total;
  for_each_run(b, [&](const PairRun& run) {
    unsigned same[kScatterUnroll], slot[kScatterUnroll];
#pragma unroll
    for (int u = 0; u < kScatterUnroll; ++u) {
      slot[u] = 0;
      if (group_leader(run.key[u], run.live[u], &same[u])) {
        slot[u] = atomicAdd(&s.fill[run.key[u]], __popc(same[u]));
      }
    }
#pragma unroll
    for (int u = 0; u < kScatterUnroll; ++u) {
      slot[u] = __shfl_sync(0xffffffffu, slot[u], __ffs(same[u]) - 1) +
                __popc(same[u] & ((1u << (threadIdx.x & 31)) - 1));
    }
#pragma unroll
    for (int u = 0; u < kScatterUnroll; ++u) {
      if (run.live[u]) {
        const unsigned key = run.key[u];
        const unsigned pos = __ldcg(&s.off[key]) + base[key / slice] + slot[u];
        s.idx[pos] = run.t[u];
        s.v[pos] = __ldg(b.vbank + run.e[u]);
        if (b.vals) s.u[pos] = __ldg(b.vals + run.e[u]);
      }
    }
  });
}

// Step 4 of the long-row body, a normal launch after steps 1-3: one block
// per (tile, row), as the tile body, but reading only the tile's buckets;
// the blocks of row 0 zero their tile's second counters for the next
// launch.
__global__ void __launch_bounds__(kThreads)
scatter_gather_kernel(ScatterBank b, unsigned* __restrict__ counters, unsigned* __restrict__ work) {
  __shared__ __align__(16) float acc[kTile];
  const Buckets s = buckets(b, counters, work);
  const long long lo = static_cast<long long>(blockIdx.x) * kTile;
  const int len = static_cast<int>(min(static_cast<long long>(kTile), b.n - lo));
  const int r = blockIdx.y;
  const unsigned key0 = blockIdx.x * b.peers;
  if (r == 0) {
    for (int p = threadIdx.x; p < b.peers; p += kThreads) s.fill[key0 + p] = 0;
  }
  int p0, p1;
  row_peers(b, r, &p0, &p1);
  zero_tile(acc, len);
  __syncthreads();
  for (int p = p0; p < p1; ++p) {
    add_entries(acc, s.idx, r < b.mixes ? s.v : s.u, s.starts[key0 + p], s.starts[key0 + p + 1],
                lo, len, row_weight(b, r, p));
    __syncthreads();  // this peer's adds land before the next peer's
  }
  store_tile(acc, b.out + static_cast<long long>(r) * b.n + lo, len);
}

// Blocks of `kernel` that fit on the current device at once, capped by
// `cap` and by `blocks`. The SM count and the occupancy are queried once
// per device and kernel (`which`) and kept.
int cooperative_grid(const void* kernel, int which, long long blocks, int cap, int* grid) {
  static std::atomic<int> resident[kMaxDevices][2];  // 0: not queried yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int fit = resident[dev][which].load(std::memory_order_relaxed);
  if (fit == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    fit = sms * per_sm;
    resident[dev][which].store(fit, std::memory_order_relaxed);
  }
  long long g = std::min(static_cast<long long>(fit), blocks);
  g = std::min(g, static_cast<long long>(cap));
  *grid = static_cast<int>(std::max(g, 1LL));
  return 0;
}

// The pairs all blocks of the tile body may read, for `rows` output rows
// of n.
long long tile_reads_max(int rows, long long n) { return kTileReadsBase + rows * n / 4; }

// The body of a launch of `mixes` mixes of `peers` x k pairs into rows of
// n, with or without the own rows: 1 the tile body, 2 the long-row body.
// Each block of the tile body reads its row's pairs: peers x k for a mix,
// k for an own row, so peers x k a tile for the own rows together.
int scatter_body(int mixes, int peers, long long k, long long n, int own) {
  const long long ntiles = (n + kTile - 1) / kTile;
  const long long pairs = peers * k;
  const long long reads = ntiles * (mixes + (own ? 1 : 0)) * pairs;
  const int rows = mixes + (own ? peers : 0);
  return ntiles == 1 || (pairs <= kTilePairsMax && reads <= tile_reads_max(rows, n)) ? 1 : 2;
}

}  // namespace

extern "C" {

// Rows of at most this many entries take the one-block body.
long long topk_select_small_row_max() { return kSmallRowMax; }

// Words of scratch that topk_select_launch needs for a grid of at most
// `max_grid` blocks.
int topk_select_scratch_words(int max_grid) { return kScratchHead + 2 * max_grid; }

// x (rows, n) f32 -> out_v (rows, k) f32, out_i (rows, k) int32, 1 <= k <=
// n < 2^31, rows >= 1. scratch: topk_select_scratch_words(max_grid) words
// of device memory, zero before the first launch; the kernel leaves it
// zero again. Launches on one stream may share it, launches on two may not.
// body: 0 by the row length (kSmallRowMax), 1 one block per row, 2 the
// cooperative grid. Returns a cudaError_t (0 = success).
int topk_select_launch(const float* x, int rows, long long n, long long k, float* out_v,
                       int* out_i, unsigned* scratch, int max_grid, int body, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 0) body = n <= kSmallRowMax ? 1 : 2;
  if (body == 1) {
    select_row_kernel<<<rows, kRowThreads, 0, st>>>(x, n, k, out_v, out_i);
    return static_cast<int>(cudaGetLastError());
  }
  int grid = 0;
  // at least 16 entries a thread: fewer blocks make cheaper grid syncs
  int err = cooperative_grid(reinterpret_cast<const void*>(select_grid_kernel), 0,
                             (n + 16 * kThreads - 1) / (16 * kThreads), max_grid, &grid);
  if (err) return err;
  void* args[] = {&x, &rows, &n, &k, &out_v, &out_i, &scratch};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(select_grid_kernel), dim3(grid), dim3(kThreads), args, 0, st));
}

// Entries of an output tile: the tile body's blocks and the long-row
// body's buckets cover kTile outputs each.
int topk_scatter_tile() { return kTile; }

// The tile body's limits for launches of more than one tile a row: the
// pairs one block reads (peers x k) and the pairs all blocks read (tiles x
// (mixes + (own rows ? 1 : 0)) x peers x k) for `rows` output rows of n;
// above either, the long-row body.
long long topk_scatter_tile_pairs_max() { return kTilePairsMax; }
long long topk_scatter_tile_reads_max(int rows, long long n) { return tile_reads_max(rows, n); }

// 1 (the tile body) or 2 (the long-row body): the body that body = 0
// takes for `mixes` mixes of peers x k pairs into rows of n, own rows or
// not.
int topk_scatter_body(int mixes, int peers, long long k, long long n, int own) {
  return scatter_body(mixes, peers, k, n, own);
}

// Words of the long-row body's counters (zero before its first launch; it
// leaves them zero) and of its work buffer (no initial value), for rows of
// n, peers x k pairs, own rows or not.
long long topk_scatter_counter_words(int peers, long long n) {
  return 2 * ((n + kTile - 1) / kTile) * peers;
}
long long topk_scatter_work_words(int peers, long long k, long long n, int own) {
  return 2 * ((n + kTile - 1) / kTile) * peers + 1 + kMaxLongGrid + (own ? 3 : 2) * peers * k;
}

// vbank (peers, k) f32, vals (peers, k) f32 or null, idx (peers, k) int32,
// w (mixes, peers) f32 -> out (mixes + (vals ? peers : 0), n) f32: row r <
// mixes is sum_p w[r, p] * scatter(vbank[p], idx[p]), peers added in order;
// row mixes + p is 0 + scatter(vals[p], idx[p]) * 1. Indices within one
// peer must be distinct; those outside [0, n) are dropped. n >= 1, peers x
// k < 2^31, mixes + (vals ? peers : 0) < 65536. counters and work: the long
// body's (topk_scatter_counter_words, topk_scatter_work_words; null for the
// tile body); launches on one stream may share counters, launches on two
// may not. body: 0 by topk_scatter_body, 1 the tile body, 2 the long-row
// body. Returns a cudaError_t (0 = success).
int topk_scatter_launch(const float* vbank, const float* vals, const int* idx, const float* w,
                        float* out, int mixes, int peers, long long k, long long n,
                        unsigned* counters, unsigned* work, int body, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  ScatterBank b{vbank, vals, idx, w, out, mixes, peers, k, n};
  const long long ntiles = (n + kTile - 1) / kTile;
  if (body == 0) body = scatter_body(mixes, peers, k, n, vals != nullptr);
  const unsigned rows = static_cast<unsigned>(mixes + (vals ? peers : 0));
  if (body == 1) {
    scatter_tile_kernel<<<dim3(static_cast<unsigned>(ntiles), rows), kThreads, 0, st>>>(b);
    return static_cast<int>(cudaGetLastError());
  }
  if (!counters || !work) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  constexpr long long kPairsPerBlock = kThreads * kScatterUnroll;  // one warp step each
  int err = cooperative_grid(reinterpret_cast<const void*>(scatter_bucket_kernel), 1,
                             (peers * k + kPairsPerBlock - 1) / kPairsPerBlock, kMaxLongGrid,
                             &grid);
  if (err) return err;
  void* args[] = {&b, &counters, &work};
  err = static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(scatter_bucket_kernel), dim3(grid), dim3(kThreads), args, 0,
      st));
  if (err) return err;
  scatter_gather_kernel<<<dim3(static_cast<unsigned>(ntiles), rows), kThreads, 0, st>>>(
      b, counters, work);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
