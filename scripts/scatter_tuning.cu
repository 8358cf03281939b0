// Probe of the top-k scatter's earlier kernel, for scripts/scatter_tuning.py.
//
// scatter_kernel is the cooperative kernel that src/repro_torch/kernels/csrc/
// topk.cu launched for topk_scatter_accum before its tile and long-row
// bodies: zero all n outputs with scalar stores, then for each peer a grid
// sync and a read-modify-write of out[idx] through L2. Here it can stop
// after a chosen phase, so that the phases' device times can be told apart
// by difference. Beside it: empty kernels launched cooperatively and
// normally, and the host time of a launch with the SM count and occupancy
// queried on every call (as that launch did) and with them cached.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <chrono>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// mode < 0: the whole kernel; 0: the zero pass alone; 1: the zero pass and
// one grid sync; 1 + q (q = 1 .. peers): the zero pass and peers 0 .. q-1,
// each behind its grid sync.
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const float* __restrict__ v, const int* __restrict__ idx,
               const float* __restrict__ w, float* __restrict__ out, int peers,
               long long k, long long n, int mode) {
  cg::grid_group grid = cg::this_grid();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long i = tid; i < n; i += stride) out[i] = 0.0f;
  if (mode == 0) return;
  for (int p = 0; p < peers; ++p) {
    if (mode > 1 && p == mode - 1) return;
    grid.sync();  // the previous peer's adds (or the zeroing) are done
    if (mode == 1) return;
    const float wp = w[p];
    for (long long j = tid; j < k; j += stride) {
      const long long t = idx[p * k + j];
      if (t >= 0 && t < n) out[t] = __fadd_rn(__ldcg(&out[t]), __fmul_rn(v[p * k + j], wp));
    }
  }
}

__global__ void empty_kernel() {}

// out[0 .. n) = 0 with 16-byte stores (n % 4 == 0), a grid-stride loop.
__global__ void __launch_bounds__(kThreads) fill_kernel(float4* out, long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n4; i += stride) {
    out[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

int resident_blocks(const void* kernel, int* fit) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  }
  *fit = sms * per_sm;
  return static_cast<int>(err);
}

int cached_fit = 0;

}  // namespace

extern "C" {

// The grid of the earlier launch: the blocks that fit on the card at once,
// at most one per 256 entries of max(n, k); the queries made on every call
// (cached = 0), as that launch made them, or on the first (cached = 1).
// Returns the grid, or minus a cudaError_t.
int probe_scatter_grid(long long k, long long n, int cached) {
  int fit = cached_fit;
  if (!cached || !fit) {
    int err = resident_blocks(reinterpret_cast<const void*>(scatter_kernel), &fit);
    if (err) return -err;
    cached_fit = fit;
  }
  long long g = std::min(static_cast<long long>(fit),
                         (std::max(n, k) + kThreads - 1) / kThreads);
  return static_cast<int>(std::max(g, 1LL));
}

// The earlier launch. Returns a cudaError_t.
int probe_scatter_launch(const float* v, const int* idx, const float* w, float* out, int peers,
                         long long k, long long n, int mode, int cached, void* stream) {
  const int grid = probe_scatter_grid(k, n, cached);
  if (grid < 0) return -grid;
  void* args[] = {&v, &idx, &w, &out, &peers, &k, &n, &mode};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(scatter_kernel), dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream)));
}

// An empty kernel of `grid` blocks, cooperative or normal.
int probe_empty_launch(int grid, int cooperative, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!cooperative) {
    empty_kernel<<<grid, kThreads, 0, st>>>();
    return static_cast<int>(cudaGetLastError());
  }
  void* none[1] = {nullptr};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(empty_kernel), dim3(grid), dim3(kThreads), none, 0, st));
}

// Zeroes out[0 .. n) (n % 4 == 0) with 16-byte stores, `grid` blocks.
int probe_fill_launch(float* out, long long n, int grid, void* stream) {
  fill_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(out), n / 4);
  return static_cast<int>(cudaGetLastError());
}

// Host microseconds per probe_scatter_launch call over `iters` calls (the
// device work they enqueue is not waited for).
double probe_scatter_host_us(const float* v, const int* idx, const float* w, float* out,
                             int peers, long long k, long long n, int cached, int iters,
                             void* stream) {
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    if (probe_scatter_launch(v, idx, w, out, peers, k, n, -1, cached, stream)) return -1.0;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / iters;
}

}  // extern "C"
