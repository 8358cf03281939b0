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
// count over the leaf. VGG-11's fc2/w (16,777,216 elements, 64 MiB) fits in
// no thread block's shared memory, so here the leaf is split over a
// cooperative grid (as many blocks as can be resident at once), each block
// owning one contiguous chunk of indices:
//   1. each block's max |x| goes into one word by atomicMax on the float's
//      bits (non-negative floats order as their bit patterns); grid sync;
//      every block forms the same hi0 = max * f32(1 + 1e-6) + f32(1e-30);
//   2. 64 steps: each block counts |x| >= mid over its chunk and adds the
//      count into that step's own word; grid sync; every block reads the
//      total and moves its copy of the bracket the same way. The bracket
//      never leaves the registers and no step needs the host;
//   3. each block counts its "sure" (|x| >= hi) and "edge" (lo <= |x| < hi)
//      entries; grid sync; each block sums the counts of the blocks before
//      it (exact integer ranks), then walks its chunk in index order with a
//      block-wide scan, writing every sure entry and the first
//      k - n_sure edge entries (in ascending index) to their slots.
// That is the Pallas kernel's selection and slot order exactly. Bound: the
// function reads x once (4 B per element) and writes 8 B per selected
// entry; the bisection reads x 64 + 2 times, so the kernel sits far from
// that bound (a radix or multi-level count could cut the passes).
//
// scatter: out = 0, then for p = 0 .. P-1: out[idx[p, j]] += v[p, j] * w[p].
// Within one peer the select gives distinct indices, so no two threads of
// one peer touch the same element; a grid sync between peers keeps the
// reference's peer order, so the sum is the reference's bit for bit with no
// atomics. Indices outside [0, n) are dropped, as in the Pallas kernel.
// Bound: bytes, (4 + 4) B per (value, index) read plus 4 B per output
// element written.
//
// Both use __fmul_rn / __fadd_rn where the reference rounds a product
// before adding it, so nvcc cannot contract the pair into one FMA.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBisectSteps = 64;
// scratch words: [0] max bits, [1, 65) the bisection counts, then the
// per-block sure counts and the per-block edge counts
constexpr int kScratchHead = 1 + kBisectSteps;

__device__ __forceinline__ unsigned block_sum_u32(unsigned v, unsigned* red) {
  v = __reduce_add_sync(0xffffffffu, v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  unsigned total = 0;
  for (int i = 0; i < kWarps; ++i) total += red[i];
  return total;
}

// Exclusive scan of v over the block; *total gets the block's sum.
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
  for (int i = 0; i < kWarps; ++i) {
    if (i < warp) before += red[i];
    sum += red[i];
  }
  *total = sum;
  return before + incl - v;
}

__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ x, long long n, long long k,
              float* __restrict__ out_v, int* __restrict__ out_i,
              unsigned* __restrict__ scratch) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned red[kWarps];
  const long long chunk = (n + gridDim.x - 1) / gridDim.x;
  const long long beg = min(n, chunk * static_cast<long long>(blockIdx.x));
  const long long end = min(n, beg + chunk);
  unsigned* counts = scratch + 1;
  unsigned* sure_cnt = scratch + kScratchHead;
  unsigned* edge_cnt = sure_cnt + gridDim.x;

  // 1. hi0 from the grid's max |x|
  float mx = 0.0f;
  for (long long i = beg + threadIdx.x; i < end; i += kThreads) {
    mx = fmaxf(mx, fabsf(x[i]));
  }
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMax(reinterpret_cast<int*>(scratch), __float_as_int(mx));
  }
  grid.sync();
  const float maxabs = __int_as_float(*reinterpret_cast<volatile int*>(scratch));
  float lo = 0.0f;
  float hi = __fadd_rn(__fmul_rn(maxabs, static_cast<float>(1.0 + 1e-6)),
                       static_cast<float>(1e-30));

  // 2. bisection: count(|x| >= lo) >= k and count(|x| >= hi) < k
  for (int step = 0; step < kBisectSteps; ++step) {
    const float mid = 0.5f * (lo + hi);
    unsigned c = 0;
    for (long long i = beg + threadIdx.x; i < end; i += kThreads) {
      c += fabsf(x[i]) >= mid;
    }
    c = block_sum_u32(c, red);
    if (threadIdx.x == 0 && c) atomicAdd(&counts[step], c);
    grid.sync();
    const bool big = static_cast<long long>(
                         *reinterpret_cast<volatile unsigned*>(&counts[step])) >= k;
    lo = big ? mid : lo;
    hi = big ? hi : mid;
  }

  // 3. two tiers, ranked in index order across the grid
  unsigned ns = 0, ne = 0;
  for (long long i = beg + threadIdx.x; i < end; i += kThreads) {
    const float m = fabsf(x[i]);
    ns += m >= hi;
    ne += (m >= lo) & (m < hi);
  }
  ns = block_sum_u32(ns, red);
  ne = block_sum_u32(ne, red);
  if (threadIdx.x == 0) {
    sure_cnt[blockIdx.x] = ns;
    edge_cnt[blockIdx.x] = ne;
  }
  grid.sync();
  unsigned long long s_before = 0, e_before = 0, n_sure = 0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += kThreads) {
    const unsigned sc = *reinterpret_cast<volatile unsigned*>(&sure_cnt[b]);
    n_sure += sc;
    if (b < blockIdx.x) {
      s_before += sc;
      e_before += *reinterpret_cast<volatile unsigned*>(&edge_cnt[b]);
    }
  }
  // these sums fit in 32 bits: n < 2^31
  s_before = block_sum_u32(static_cast<unsigned>(s_before), red);
  e_before = block_sum_u32(static_cast<unsigned>(e_before), red);
  n_sure = block_sum_u32(static_cast<unsigned>(n_sure), red);
  const long long fill = k - static_cast<long long>(n_sure);
  long long s_off = static_cast<long long>(s_before);
  long long e_off = static_cast<long long>(e_before);
  for (long long t0 = beg; t0 < end; t0 += kThreads) {
    const long long i = t0 + threadIdx.x;
    const bool in = i < end;
    const float v = in ? x[i] : 0.0f;
    const float m = fabsf(v);
    const bool sure = in && m >= hi;
    const bool edge = in && m >= lo && m < hi;
    // one scan for both tiers: sure in the low 16 bits, edge in the high
    unsigned total;
    const unsigned rank = block_exclusive_scan(
        static_cast<unsigned>(sure) | (static_cast<unsigned>(edge) << 16), red, &total);
    long long slot = -1;
    if (sure) {
      slot = s_off + (rank & 0xffffu);
    } else if (edge) {
      const long long er = e_off + (rank >> 16);
      if (er < fill) slot = static_cast<long long>(n_sure) + er;
    }
    if (slot >= 0) {
      out_v[slot] = v;
      out_i[slot] = static_cast<int>(i);
    }
    s_off += total & 0xffffu;
    e_off += total >> 16;
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const float* __restrict__ v, const int* __restrict__ idx,
               const float* __restrict__ w, float* __restrict__ out, int peers,
               long long k, long long n) {
  cg::grid_group grid = cg::this_grid();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long i = tid; i < n; i += stride) out[i] = 0.0f;
  for (int p = 0; p < peers; ++p) {
    grid.sync();  // the previous peer's adds (or the zeroing) are done
    const float wp = w[p];
    for (long long j = tid; j < k; j += stride) {
      const long long t = idx[p * k + j];
      // __ldcg reads L2, where the previous peer's writes from other SMs are
      if (t >= 0 && t < n) out[t] = __fadd_rn(__ldcg(&out[t]), __fmul_rn(v[p * k + j], wp));
    }
  }
}

// Blocks of `kernel` that fit on the card at once, capped by `cap` and by
// the blocks that `work` items need.
int cooperative_grid(const void* kernel, long long work, int cap, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  long long g = static_cast<long long>(sms) * per_sm;
  g = std::min(g, (work + kThreads - 1) / kThreads);
  g = std::min(g, static_cast<long long>(cap));
  *grid = static_cast<int>(std::max(g, 1LL));
  return 0;
}

}  // namespace

extern "C" {

// Words of scratch that topk_select_launch needs for a grid of at most
// `max_grid` blocks.
int topk_select_scratch_words(int max_grid) { return kScratchHead + 2 * max_grid; }

// x (n,) f32 -> out_v (k,) f32, out_i (k,) int32, 1 <= k <= n < 2^31.
// scratch: topk_select_scratch_words(max_grid) words of device memory,
// zeroed here on the stream. Returns a cudaError_t (0 = success).
int topk_select_launch(const float* x, long long n, long long k, float* out_v,
                       int* out_i, unsigned* scratch, int max_grid, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int grid = 0;
  int err = cooperative_grid(reinterpret_cast<const void*>(select_kernel), n, max_grid, &grid);
  if (err) return err;
  err = static_cast<int>(cudaMemsetAsync(
      scratch, 0, sizeof(unsigned) * topk_select_scratch_words(grid), st));
  if (err) return err;
  void* args[] = {&x, &n, &k, &out_v, &out_i, &scratch};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(select_kernel), dim3(grid), dim3(kThreads), args, 0, st));
}

// v (peers, k) f32, idx (peers, k) int32, w (peers,) f32 -> out (n,) f32.
// Indices within one peer must be distinct. Returns a cudaError_t.
int topk_scatter_launch(const float* v, const int* idx, const float* w, float* out,
                        int peers, long long k, long long n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int grid = 0;
  int err = cooperative_grid(reinterpret_cast<const void*>(scatter_kernel), std::max(n, k),
                             1 << 20, &grid);
  if (err) return err;
  void* args[] = {&v, &idx, &w, &out, &peers, &k, &n};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(scatter_kernel), dim3(grid), dim3(kThreads), args, 0, st));
}

}  // extern "C"
