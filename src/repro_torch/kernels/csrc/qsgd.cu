// QSGD quantize / dequantize / dequantize-and-reduce for Hopper (sm_90a),
// bound with a plain C interface and loaded through ctypes by
// repro_torch/kernels/qsgd.py.
//
// Replaces the Pallas TPU kernels repro/kernels/qsgd.py:_quantize_kernel
// (wrapper qsgd_quantize), :_dequantize_kernel (wrapper qsgd_dequantize) and
// :_dequant_reduce_kernel (wrapper qsgd_dequant_reduce).
//
// Bound: device memory. quantize reads 8 B per element (x and u) and writes
// 1 B per element plus 4 B per bucket row; dequantize reads 1 B per element
// plus 4 B per row and writes 4 B; dequantize-and-reduce reads P bytes of
// levels per output element and writes 4 B. All do a handful of fp32
// operations per element, two orders of magnitude below the card's fp32
// rate per byte.
//
// Design: one thread block per bucket row. The TPU kernel keeps an
// (8, bucket) tile in VMEM and reduces each row there; here the row's sum of
// squares is reduced in registers and shared memory, so the norm never goes
// through device memory before it is used. The second pass re-reads the row
// (at most 8 KB for a 2048 bucket), which L1/L2 serves. The loop stride is
// the block size, so any bucket length works, including a ragged tail
// shorter than one block. When the bucket is a multiple of 4 and the rows
// are aligned, threads move 16-byte vectors (float4 in, char4 levels): byte
// loads and stores of one int8 per thread leave most of each memory
// transaction unused.
//
// Numerics follow the reference's operation order element for element:
// r = |x| / max(norm, 1e-30) * s, l = floor(r), xi = l + (u < r - l),
// clip(xi, 0, s) * sign(x). Build without --use_fast_math: the division and
// sqrtf must be IEEE-rounded for the levels to match the plain version
// outside the rounding-boundary band.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (kThreads >> 5) ? scratch[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  return scratch[0];
}

__device__ __forceinline__ int8_t quantize_one(float v, float u, float safe,
                                               float s) {
  const float r = fabsf(v) / safe * s;
  const float l = floorf(r);
  float xi = l + ((u < r - l) ? 1.0f : 0.0f);
  xi = fminf(fmaxf(xi, 0.0f), s);
  const float sign = (v > 0.0f) ? 1.0f : ((v < 0.0f) ? -1.0f : 0.0f);
  return static_cast<int8_t>(static_cast<int>(xi * sign));
}

// kVec: the bucket is a multiple of 4 and every row starts 16-byte aligned,
// so each thread moves float4 / char4 vectors (16 B of x and u, 4 B of
// levels) instead of single elements.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ u,
                int8_t* __restrict__ levels, float* __restrict__ norms,
                int bucket, float s) {
  __shared__ float scratch[kThreads / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * bucket;
  const float* xr = x + base;
  const float* ur = u + base;
  int8_t* lr = levels + base;

  float acc = 0.0f;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = threadIdx.x; i < bucket / 4; i += kThreads) {
      const float4 v = x4[i];
      acc += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
  } else {
    for (int i = threadIdx.x; i < bucket; i += kThreads) {
      const float v = xr[i];
      acc += v * v;
    }
  }
  const float norm = sqrtf(block_sum(acc, scratch));
  const float safe = fmaxf(norm, 1e-30f);

  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* u4 = reinterpret_cast<const float4*>(ur);
    char4* l4 = reinterpret_cast<char4*>(lr);
    for (int i = threadIdx.x; i < bucket / 4; i += kThreads) {
      const float4 v = x4[i];
      const float4 w = u4[i];
      l4[i] = make_char4(quantize_one(v.x, w.x, safe, s), quantize_one(v.y, w.y, safe, s),
                         quantize_one(v.z, w.z, safe, s), quantize_one(v.w, w.w, safe, s));
    }
  } else {
    for (int i = threadIdx.x; i < bucket; i += kThreads) {
      lr[i] = quantize_one(xr[i], ur[i], safe, s);
    }
  }
  if (threadIdx.x == 0) norms[blockIdx.x] = norm;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ levels,
                  const float* __restrict__ norms, float* __restrict__ out,
                  int bucket, float s) {
  const size_t base = static_cast<size_t>(blockIdx.x) * bucket;
  const float scale = norms[blockIdx.x] / s;
  if (kVec) {
    const char4* l4 = reinterpret_cast<const char4*>(levels + base);
    float4* o4 = reinterpret_cast<float4*>(out + base);
    for (int i = threadIdx.x; i < bucket / 4; i += kThreads) {
      const char4 q = l4[i];
      o4[i] = make_float4(static_cast<float>(q.x) * scale, static_cast<float>(q.y) * scale,
                          static_cast<float>(q.z) * scale, static_cast<float>(q.w) * scale);
    }
  } else {
    for (int i = threadIdx.x; i < bucket; i += kThreads) {
      out[base + i] = static_cast<float>(levels[base + i]) * scale;
    }
  }
}

// Dequantize-and-reduce over P peer banks: out[row] = sum_p lev[p][row] *
// scale[p], scale[p] = (w[p] * norm[p][row]) / s, in the Pallas kernel's
// order: the scale is rounded first, then each product, then the sum runs
// p = 0 .. P-1 from 0. The explicit _rn intrinsics keep nvcc from contracting
// a product and the following add into one FMA, which would round once
// where the plain version rounds twice. The P scales of the row are computed
// once into shared memory; each thread then loops over P for its elements,
// so the dense per-peer banks are never written to device memory.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dequant_reduce_kernel(const int8_t* __restrict__ levels,
                      const float* __restrict__ norms,
                      const float* __restrict__ w, float* __restrict__ out,
                      int peers, long long nb, int bucket, float s) {
  extern __shared__ float scale[];  // (peers,)
  const long long row = blockIdx.x;
  for (int p = threadIdx.x; p < peers; p += kThreads) {
    scale[p] = __fdiv_rn(__fmul_rn(w[p], norms[p * nb + row]), s);
  }
  __syncthreads();
  const size_t base = static_cast<size_t>(row) * bucket;
  const size_t peer_stride = static_cast<size_t>(nb) * bucket;
  if (kVec) {
    float4* o4 = reinterpret_cast<float4*>(out + base);
    for (int i = threadIdx.x; i < bucket / 4; i += kThreads) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int p = 0; p < peers; ++p) {
        const char4 q =
            reinterpret_cast<const char4*>(levels + p * peer_stride + base)[i];
        const float c = scale[p];
        acc.x = __fadd_rn(acc.x, __fmul_rn(static_cast<float>(q.x), c));
        acc.y = __fadd_rn(acc.y, __fmul_rn(static_cast<float>(q.y), c));
        acc.z = __fadd_rn(acc.z, __fmul_rn(static_cast<float>(q.z), c));
        acc.w = __fadd_rn(acc.w, __fmul_rn(static_cast<float>(q.w), c));
      }
      o4[i] = acc;
    }
  } else {
    for (int i = threadIdx.x; i < bucket; i += kThreads) {
      float acc = 0.0f;
      for (int p = 0; p < peers; ++p) {
        const float q = static_cast<float>(levels[p * peer_stride + base + i]);
        acc = __fadd_rn(acc, __fmul_rn(q, scale[p]));
      }
      out[base + i] = acc;
    }
  }
}

}  // namespace

extern "C" {

// buckets x and uniforms u: (nb, bucket) f32 -> levels (nb, bucket) int8 and
// norms (nb,) f32. Returns the cudaError_t of the launch (0 = success).
// vec != 0: bucket % 4 == 0 and x, u 16-byte and levels 4-byte aligned.
int qsgd_quantize_launch(const float* x, const float* u, int8_t* levels,
                         float* norms, long long nb, int bucket, float s,
                         int vec, void* stream) {
  if (nb > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned grid = static_cast<unsigned>(nb);
    if (vec) {
      quantize_kernel<true><<<grid, kThreads, 0, st>>>(x, u, levels, norms, bucket, s);
    } else {
      quantize_kernel<false><<<grid, kThreads, 0, st>>>(x, u, levels, norms, bucket, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// levels (nb, bucket) int8 and norms (nb,) f32 -> out (nb, bucket) f32.
// vec != 0: bucket % 4 == 0, levels 4-byte and out 16-byte aligned.
int qsgd_dequantize_launch(const int8_t* levels, const float* norms, float* out,
                           long long nb, int bucket, float s, int vec,
                           void* stream) {
  if (nb > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned grid = static_cast<unsigned>(nb);
    if (vec) {
      dequantize_kernel<true><<<grid, kThreads, 0, st>>>(levels, norms, out, bucket, s);
    } else {
      dequantize_kernel<false><<<grid, kThreads, 0, st>>>(levels, norms, out, bucket, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// levels (peers, nb, bucket) int8, norms (peers, nb) f32 and weights w
// (peers,) f32 -> out (nb, bucket) f32. vec != 0: bucket % 4 == 0, levels
// 4-byte and out 16-byte aligned.
int qsgd_dequant_reduce_launch(const int8_t* levels, const float* norms,
                               const float* w, float* out, int peers,
                               long long nb, int bucket, float s, int vec,
                               void* stream) {
  if (nb > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned grid = static_cast<unsigned>(nb);
    const size_t smem = static_cast<size_t>(peers) * sizeof(float);
    if (vec) {
      dequant_reduce_kernel<true><<<grid, kThreads, smem, st>>>(
          levels, norms, w, out, peers, nb, bucket, s);
    } else {
      dequant_reduce_kernel<false><<<grid, kThreads, smem, st>>>(
          levels, norms, w, out, peers, nb, bucket, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
