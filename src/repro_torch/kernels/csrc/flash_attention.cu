// Flash attention forward for Hopper (sm_90a), bound with a plain C
// interface and loaded through ctypes by repro_torch/kernels/flash_attention.py.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:_flash_kernel
// (wrapper flash_attention).
//
// What it computes, for batch b, query head h (reading KV head h / (H / K)),
// query i and key j, both counted from 0:
//   s_ij  = (q_i * scale) . k_j                      scale = 1 / sqrt(D), f32
//   s_ij  = tanh(s_ij / softcap) * softcap            when softcap > 0
//   valid = j < Skv and, only when causal, 0 <= i - j < window (window 0: no bound)
//   o_i   = sum_j p_ij v_j / max(sum_j p_ij, 1e-30)   online softmax over key tiles
// q, k and v are f32 or bf16 (read in their type, computed in f32); o is
// written in q's type. exp is expf and tanh tanhf (no --use_fast_math).
//
// Bound: operations. A (query, key) pair costs 4D operations (a D-deep dot
// product and a D-wide multiply-add into the output) against the 2D-byte
// rows of q, k, v and o moved once each: at gemma2-2b's D = 256 and 8192
// tokens the pairs are 2,000x more work than bytes, far above the card's
// 295 operations per byte in bf16 on the tensor cores, let alone its 20 in
// fp32 outside them. This kernel runs that work on the fp32 units.
//
// Design. The TPU walks the key blocks on its sequential grid and keeps
// the running max m, sum l and the (Qb, D) accumulator in VMEM scratch.
// Here one block of 256 threads owns one (batch, head, 64-row query tile),
// keeps m and l in registers (the 16 threads of a row group hold copies)
// and the (64, D) accumulator in registers (4x4 micro-tiles), and loops
// over the key tiles that can hold a valid key: up to the diagonal when
// causal, from q0 - window + 1 when windowed. Skipping a tile changes
// nothing: a masked entry contributes exp(-inf - m) = 0. Masked scores are
// -inf and m starts at -1e30, so a row that has not met a valid key yet
// adds nothing (the Pallas kernel adds weight 1 there and clears it with
// alpha = 0 once a valid key arrives), and a row that meets none returns
// 0. Both products are register-tiled f32 products out of shared memory:
// q and k stored k-major (transposed, pitch 68) so that neighbouring
// threads read neighbouring float4s, v and the probabilities likewise. At
// D = 256 the q, k and v tiles take 64 KB each in f32, 222,464 bytes in
// all with the probabilities, set with cudaFuncSetAttribute (one block per
// SM). Query tiles run longest first, so the causal tail does not trail.
// Rows and keys past the sequence read as zero and are masked: the
// wrapper pads nothing.
//
// What holds it back: the fp32 units at 1/15 of the bf16 tensor-core rate,
// two shared-memory float4 reads per 16 FMAs, and one block of 8 warps per
// SM at D = 256. wgmma with TMA-fed bf16 tiles is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileQ = 64;  // query rows of a block
constexpr int kTileK = 64;  // key rows of a step
constexpr int kPitch = kTileQ + 4;  // k-major pitch of the transposed q, k and p tiles
constexpr int kMaxD = 256;
constexpr int kMaxOTiles = kMaxD / 64;  // 4x4 micro-tiles of the (64, D) output per thread
constexpr float kMInit = -1e30f;  // the running max before any valid key, as in Pallas

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ void fma44(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// The max (or sum) over the 16 lanes of a row group: lanes 0-15 and 16-31
// of a warp each hold one row group of the score tile.
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int Sq, int Skv, int H, int rep, int D, Strides qs,
                       Strides ks, Strides vs, float scale, float softcap, int causal,
                       int window) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;                 // q * scale, k-major: [D][kPitch]
  float* Kt = Qt + D * kPitch;      // k tile, k-major: [D][kPitch]
  float* Vs = Kt + D * kPitch;      // v tile: [kTileK][D]
  float* Pt = Vs + kTileK * D;      // probabilities, key-major: [kTileK][kPitch]
  float* rowv = Pt + kTileK * kPitch;  // per query row: alpha of the step, l at the end

  const int nq = (Sq + kTileQ - 1) / kTileQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTileQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int rows = min(kTileQ, Sq - q0);
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / rep) * ks.h;
  const T* vb = v + b * vs.b + (h / rep) * vs.h;

  // q tile, scaled after the f32 cast; rows past the sequence read 0
  for (int idx = threadIdx.x; idx < kTileQ * D; idx += kThreads) {
    const int r = idx % kTileQ, d = idx / kTileQ;
    Qt[d * kPitch + r] = r < rows ? to_float(qb[(q0 + r) * qs.s + d]) * scale : 0.0f;
  }

  // the keys any row of this tile may see
  int j_begin = 0, j_end = Skv;
  if (causal) {
    j_end = min(Skv, q0 + rows);
    if (window > 0) j_begin = max(0, q0 - window + 1);
  }

  // score-tile roles: rows ri..ri+3, keys cj..cj+3 of the (64, 64) tile
  const int ri = 4 * (threadIdx.x / 16), cj = 4 * (threadIdx.x % 16);
  const bool row_leader = (threadIdx.x % 16) == 0;
  const int D4 = D / 4, otiles = 16 * D4;
  float m_run[4], l_run[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = kMInit;
    l_run[r] = 0.0f;
  }
  float acc[kMaxOTiles][4][4];
#pragma unroll
  for (int u = 0; u < kMaxOTiles; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[u][r][c] = 0.0f;

  for (int j0 = j_begin; j0 < j_end; j0 += kTileK) {
    __syncthreads();  // the previous step has finished reading Kt, Vs and Pt
    for (int idx = threadIdx.x; idx < kTileK * D; idx += kThreads) {
      const int r = idx % kTileK, d = idx / kTileK, j = j0 + r;
      Kt[d * kPitch + r] = j < Skv ? to_float(kb[j * ks.s + d]) : 0.0f;
    }
    for (int idx = threadIdx.x; idx < kTileK * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D, j = j0 + r;
      Vs[idx] = j < Skv ? to_float(vb[j * vs.s + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      fma44(s, *reinterpret_cast<const float4*>(Qt + d * kPitch + ri),
            *reinterpret_cast<const float4*>(Kt + d * kPitch + cj));
    }

    // softcap, mask, and the online softmax of rows ri..ri+3
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ri + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + cj + c;
        float x = s[r][c];
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        bool ok = j < Skv;
        if (causal) {
          const int rel = i - j;
          ok = ok && rel >= 0 && (window <= 0 || rel < window);
        }
        s[r][c] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m_run[r], group_max(mx));
      const float alpha = expf(m_run[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
      }
      l_run[r] = l_run[r] * alpha + group_sum(sum);
      m_run[r] = m_new;
      if (row_leader) rowv[ri + r] = alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<float4*>(Pt + (cj + c) * kPitch + ri) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
    __syncthreads();

    // acc = acc * alpha + p v over the 64 keys of the tile
#pragma unroll
    for (int u = 0; u < kMaxOTiles; ++u) {
      const int t = threadIdx.x + u * kThreads;
      if (t < otiles) {
        const int orow = 4 * (t / D4), ocol = 4 * (t % D4);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = rowv[orow + r];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[u][r][c] *= a;
        }
#pragma unroll 4
        for (int jj = 0; jj < kTileK; ++jj) {
          fma44(acc[u], *reinterpret_cast<const float4*>(Pt + jj * kPitch + orow),
                *reinterpret_cast<const float4*>(Vs + jj * D + ocol));
        }
      }
    }
  }

  __syncthreads();
  if (row_leader) {
#pragma unroll
    for (int r = 0; r < 4; ++r) rowv[ri + r] = l_run[r];
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kMaxOTiles; ++u) {
    const int t = threadIdx.x + u * kThreads;
    if (t < otiles) {
      const int orow = 4 * (t / D4), ocol = 4 * (t % D4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (orow + r < rows) {
          const float denom = fmaxf(rowv[orow + r], 1e-30f);
          T* out = o + ((static_cast<long long>(b) * Sq + q0 + orow + r) * H + h) * D + ocol;
#pragma unroll
          for (int c = 0; c < 4; ++c) store(out + c, acc[u][r][c] / denom);
        }
      }
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(2 * D * kPitch) + kTileK * D + kTileK * kPitch +
                          kTileQ);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int Sq, int Skv,
           int H, int K, int D, Strides qs, Strides ks, Strides vs, float scale, float softcap,
           int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTileQ - 1) / kTileQ, H, batch);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, H / K, D, qs, ks, vs, scale, softcap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int batch, int Sq, int Skv, int H, int K, int D, int bf16,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh,
                                      long long v_sb, long long v_ss, long long v_sh,
                                      float scale, float softcap, int causal, int window,
                                      void* stream) {
  if (D <= 0 || D % 32 || D > kMaxD || K <= 0 || H % K || batch <= 0 || Sq <= 0 || Skv <= 0 ||
      batch > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(q, k, v, o, batch, Sq, Skv, H, K, D, qs, ks, vs, scale, softcap,
                                 causal, window, st);
  }
  return launch<float>(q, k, v, o, batch, Sq, Skv, H, K, D, qs, ks, vs, scale, softcap, causal,
                       window, st);
}
