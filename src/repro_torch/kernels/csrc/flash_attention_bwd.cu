// Flash attention backward for Hopper (sm_90a), bound with a plain C
// interface and loaded through ctypes by repro_torch/kernels/flash_attention.py.
//
// Stands for the reference's jax.grad of the function that the Pallas TPU
// kernel repro/kernels/flash_attention.py:_flash_kernel computes: the
// reference's models differentiate attend (repro/models/layers.py:188), and
// the Pallas kernel has no backward of its own.
//
// What it computes, for batch b, query head h (reading KV head h / (H / K)),
// query i and key j, both counted from 0, given the output's cotangent dO:
//   u_ij  = (q_i . k_j) * scale                   scale = 1 / sqrt(D), f32
//   t_ij  = tanh(u_ij / softcap), s_ij = softcap * t_ij   (s = u without softcap)
//   valid = j < Skv and, only when causal, 0 <= i - j < window (window 0: no bound)
//   p_ij  = exp(s_ij - lse_i) on the valid pairs, else 0
//   dv_j  = sum_i p_ij dO_i,  dp_ij = dO_i . v_j,  delta_i = dO_i . o_i
//   du_ij = p_ij (dp_ij - delta_i) (1 - t_ij^2)    (no factor without softcap)
//   dq_i  = scale sum_j du_ij k_j,  dk_j = scale sum_i du_ij q_i
// dk and dv sum over the H / K query heads of each KV group. q, k, v and dO
// are f32 or bf16 and every product runs in f32 on the CUDA cores; dq, dk
// and dv are written once, in the inputs' type. A query row with no valid
// key gets zero gradient (the forward kernel gives it a zero output).
//
// Three launches on one stream, none with atomics, so a gradient is the
// same bits on every run:
//   (a) stats: one block per (batch, head, 64-query tile) runs the forward
//       again in f32 (online softmax over 32-key tiles, as the f32 forward
//       body does), and writes lse_i = m_i + log(l_i) and delta_i = dO_i .
//       o_i with o_i in f32. Recomputing leaves the forward kernels as they
//       are, and delta from the f32 o (not the forward's bf16 output) keeps
//       the cancellation in dp - delta at f32 accuracy.
//   (b) dq: one block per (batch, head, 64-query tile) walks the key tiles
//       that its rows may see, recomputes s and dp for each (64 x 32) tile,
//       and adds du k into a (64, D) f32 accumulator in registers.
//   (c) dk and dv: one block per (batch, KV head, 32-key tile) walks the
//       group's query heads and the query tiles that may see its keys, and
//       adds p^T dO and du^T q into two (32, D) accumulators in registers.
// Each pass skips the tiles the mask empties, as the forward does. Tiles
// live in shared memory as f32 rows with a pitch of D + 4 floats; a (64 x
// 32) score tile is 2 rows x 4 keys a thread (rows r and r + 32, keys c,
// c + 8, c + 16, c + 24: float4 reads along D without bank conflicts), and
// the accumulators are 4 x 4 micro-tiles fed from a transposed copy of the
// probabilities. At D = 256 pass (c) holds k, v, q and dO tiles and two
// probability tiles, 220,672 bytes, set with cudaFuncSetAttribute.
//
// Bound: operations. The function's five products (s, dp, dv, dq, dk) cost
// 10 D operations a valid pair against 2 D bytes a row of each tensor; this
// design spends 18 D (passes (a) and (b) recompute s, pass (a) also o, pass
// (b) and (c) each dp) at the fp32 rate, 1/15 of the bf16 tensor-core rate
// the bound takes for bf16 inputs. What holds it back further: two float4
// shared-memory reads per 8 FMAs in the score tiles, and one block of 8
// warps per SM at D = 256. A tensor-core body (wgmma, as the forward's) is
// the redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTq = 64;             // query rows of a tile
constexpr int kTk = 32;             // key rows of a tile
constexpr int kMaxD = 256;
constexpr int kMaxUq = kMaxD / 64;   // (64, D) accumulator: 4 D micro-tiles of 4 x 4, 4 D / 256 a thread
constexpr int kMaxUk = kMaxD / 128;  // (32, D) accumulator: 2 D micro-tiles of 4 x 4, 2 D / 256 a thread
constexpr int kPq = kTq + 4;        // pitch of key-major probability tiles [key][query]
constexpr int kPk = kTk + 8;        // pitch of query-major probability tiles [query][key]
constexpr float kMInit = -1e30f;    // the running max before any valid key

struct Strides {
  long long b, s, h;  // elements between batches, sequence positions, heads
};

struct Problem {
  int Sq, Skv, H, rep, D;
  Strides qs, ks, vs, dos;
  float scale, softcap;
  int causal, window;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ bool is_valid(int i, int j, const Problem& p) {
  if (i >= p.Sq || j >= p.Skv) return false;
  if (!p.causal) return true;
  const int rel = i - j;
  return rel >= 0 && (p.window <= 0 || rel < p.window);
}

// n rows of D values from row r0 of src (row stride ld elements) into dst
// [n][pitch] as f32 times mul; rows past S read 0.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, long long ld,
                                          int r0, int n, int S, int D, int pitch, float mul) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D, i = r0 + r;
    dst[r * pitch + d] = i < S ? to_float(src[i * ld + d]) * mul : 0.0f;
  }
}

// acc[r][c] += A[row_r] . B[key_c] over D for rows rq, rq + 32 of A
// ([64][pitch]) and keys ck + 8c of B ([32][pitch]).
__device__ __forceinline__ void score_tile(float (&acc)[2][4], const float* A, const float* Bm,
                                           int rq, int ck, int D, int pitch) {
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + rq * pitch + d);
    const float4 a1 = *reinterpret_cast<const float4*>(A + (rq + 32) * pitch + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 b = *reinterpret_cast<const float4*>(Bm + (ck + 8 * c) * pitch + d);
      acc[0][c] = fmaf(a0.x, b.x, acc[0][c]);
      acc[0][c] = fmaf(a0.y, b.y, acc[0][c]);
      acc[0][c] = fmaf(a0.z, b.z, acc[0][c]);
      acc[0][c] = fmaf(a0.w, b.w, acc[0][c]);
      acc[1][c] = fmaf(a1.x, b.x, acc[1][c]);
      acc[1][c] = fmaf(a1.y, b.y, acc[1][c]);
      acc[1][c] = fmaf(a1.z, b.z, acc[1][c]);
      acc[1][c] = fmaf(a1.w, b.w, acc[1][c]);
    }
  }
}

__device__ __forceinline__ void fma44(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// The max (or sum) over the 8 lanes that hold one row of a score tile.
__device__ __forceinline__ float group8_max(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group8_sum(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The keys [begin, end) that some row of the query tile [q0, q0 + rows) may see.
__device__ __forceinline__ void key_range(int q0, int rows, const Problem& p, int* begin,
                                          int* end) {
  *begin = 0;
  *end = p.Skv;
  if (p.causal) {
    *end = min(p.Skv, q0 + rows);
    if (p.window > 0) *begin = max(0, q0 - p.window + 1);
  }
}

// The capped score, with t = tanh(u / softcap) for the derivative (0 without softcap).
__device__ __forceinline__ float capped(float u, float softcap, float* t) {
  if (softcap > 0.0f) {
    *t = tanhf(u / softcap);
    return softcap * *t;
  }
  *t = 0.0f;
  return u;
}

// ---------------------------------------------------------------------------
// (a) row statistics: lse and delta
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dO, float* __restrict__ lse, float* __restrict__ delta,
                 Problem p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, pitch = D + 4;
  float* Qs = smem;                // q * scale, then o: [kTq][pitch]
  float* Ks = Qs + kTq * pitch;    // [kTk][pitch]
  float* Vs = Ks + kTk * pitch;    // [kTk][pitch]
  float* Pt = Vs + kTk * pitch;    // probabilities, key-major: [kTk][kPq]
  float* rowv = Pt + kTk * kPq;    // per query row: alpha of the step, l at the end

  const int nq = (p.Sq + kTq - 1) / kTq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTq;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int rows = min(kTq, p.Sq - q0);
  const T* qb = q + b * p.qs.b + h * p.qs.h;
  const T* kb = k + b * p.ks.b + (h / p.rep) * p.ks.h;
  const T* vb = v + b * p.vs.b + (h / p.rep) * p.vs.h;
  const T* dob = dO + b * p.dos.b + h * p.dos.h;
  load_rows(Qs, qb, p.qs.s, q0, kTq, p.Sq, D, pitch, p.scale);
  int j_begin, j_end;
  key_range(q0, rows, p, &j_begin, &j_end);

  const int rq = threadIdx.x / 8, ck = threadIdx.x % 8;
  const int D4 = D / 4, otiles = 16 * D4;
  float m_run[2] = {kMInit, kMInit}, l_run[2] = {0.0f, 0.0f};
  float acc[kMaxUq][4][4];
#pragma unroll
  for (int u = 0; u < kMaxUq; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[u][r][c] = 0.0f;

  for (int j0 = j_begin; j0 < j_end; j0 += kTk) {
    __syncthreads();  // the previous step has finished reading Ks, Vs and Pt
    load_rows(Ks, kb, p.ks.s, j0, kTk, p.Skv, D, pitch, 1.0f);
    load_rows(Vs, vb, p.vs.s, j0, kTk, p.Skv, D, pitch, 1.0f);
    __syncthreads();
    float s[2][4] = {};
    score_tile(s, Qs, Ks, rq, ck, D, pitch);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rq + 32 * r, i = q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float t;
        const float x = capped(s[r][c], p.softcap, &t);
        s[r][c] = is_valid(i, j0 + ck + 8 * c, p) ? x : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m_run[r], group8_max(mx));
      const float alpha = expf(m_run[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
        Pt[(ck + 8 * c) * kPq + row] = s[r][c];
      }
      l_run[r] = l_run[r] * alpha + group8_sum(sum);
      m_run[r] = m_new;
      if (ck == 0) rowv[row] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kMaxUq; ++u) {
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
        for (int jj = 0; jj < kTk; ++jj) {
          fma44(acc[u], *reinterpret_cast<const float4*>(Pt + jj * kPq + orow),
                *reinterpret_cast<const float4*>(Vs + jj * pitch + ocol));
        }
      }
    }
  }

  __syncthreads();  // every thread is done with Qs: it takes o now
  if (ck == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rq + 32 * r, i = q0 + row;
      rowv[row] = l_run[r];
      // a row with no valid key has l = 0 and never reads its lse
      if (i < p.Sq) lse[(static_cast<long long>(b) * p.H + h) * p.Sq + i] =
          l_run[r] > 0.0f ? m_run[r] + logf(l_run[r]) : 0.0f;
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kMaxUq; ++u) {
    const int t = threadIdx.x + u * kThreads;
    if (t < otiles) {
      const int orow = 4 * (t / D4), ocol = 4 * (t % D4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float denom = fmaxf(rowv[orow + r], 1e-30f);
#pragma unroll
        for (int c = 0; c < 4; ++c) Qs[(orow + r) * pitch + ocol + c] = acc[u][r][c] / denom;
      }
    }
  }
  __syncthreads();
  // delta_i = dO_i . o_i: four lanes a row, each over every fourth column
  const int row = threadIdx.x / 4, part = threadIdx.x % 4, i = q0 + row;
  float sum = 0.0f;
  if (i < p.Sq) {
    for (int d = part; d < D; d += 4) sum = fmaf(to_float(dob[i * p.dos.s + d]), Qs[row * pitch + d], sum);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (part == 0 && i < p.Sq) delta[(static_cast<long long>(b) * p.H + h) * p.Sq + i] = sum;
}

// ---------------------------------------------------------------------------
// (b) dq
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dO, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, Problem p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, pitch = D + 4;
  float* Qs = smem;                // q * scale: [kTq][pitch]
  float* dOs = Qs + kTq * pitch;   // [kTq][pitch]
  float* Ks = dOs + kTq * pitch;   // [kTk][pitch]
  float* Vs = Ks + kTk * pitch;    // [kTk][pitch]
  float* dUt = Vs + kTk * pitch;   // du, key-major: [kTk][kPq]
  float* rl = dUt + kTk * kPq;     // lse of the tile's rows
  float* rd = rl + kTq;            // delta of the tile's rows

  const int nq = (p.Sq + kTq - 1) / kTq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTq;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int rows = min(kTq, p.Sq - q0);
  const T* kb = k + b * p.ks.b + (h / p.rep) * p.ks.h;
  const T* vb = v + b * p.vs.b + (h / p.rep) * p.vs.h;
  load_rows(Qs, q + b * p.qs.b + h * p.qs.h, p.qs.s, q0, kTq, p.Sq, D, pitch, p.scale);
  load_rows(dOs, dO + b * p.dos.b + h * p.dos.h, p.dos.s, q0, kTq, p.Sq, D, pitch, 1.0f);
  const long long stat0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
  for (int r = threadIdx.x; r < kTq; r += kThreads) {
    rl[r] = r < rows ? lse[stat0 + q0 + r] : 0.0f;
    rd[r] = r < rows ? delta[stat0 + q0 + r] : 0.0f;
  }
  int j_begin, j_end;
  key_range(q0, rows, p, &j_begin, &j_end);

  const int rq = threadIdx.x / 8, ck = threadIdx.x % 8;
  const int D4 = D / 4, otiles = 16 * D4;
  float acc[kMaxUq][4][4];
#pragma unroll
  for (int u = 0; u < kMaxUq; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[u][r][c] = 0.0f;

  for (int j0 = j_begin; j0 < j_end; j0 += kTk) {
    __syncthreads();  // the previous step has finished reading Ks, Vs and dUt
    load_rows(Ks, kb, p.ks.s, j0, kTk, p.Skv, D, pitch, 1.0f);
    load_rows(Vs, vb, p.vs.s, j0, kTk, p.Skv, D, pitch, 1.0f);
    __syncthreads();
    float s[2][4] = {}, dp[2][4] = {};
    score_tile(s, Qs, Ks, rq, ck, D, pitch);
    score_tile(dp, dOs, Vs, rq, ck, D, pitch);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rq + 32 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float du = 0.0f;
        if (is_valid(q0 + row, j0 + ck + 8 * c, p)) {
          float t;
          const float x = capped(s[r][c], p.softcap, &t);
          du = expf(x - rl[row]) * (dp[r][c] - rd[row]) * (1.0f - t * t);
        }
        dUt[(ck + 8 * c) * kPq + row] = du;
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kMaxUq; ++u) {
      const int t = threadIdx.x + u * kThreads;
      if (t < otiles) {
        const int orow = 4 * (t / D4), ocol = 4 * (t % D4);
#pragma unroll 4
        for (int jj = 0; jj < kTk; ++jj) {
          fma44(acc[u], *reinterpret_cast<const float4*>(dUt + jj * kPq + orow),
                *reinterpret_cast<const float4*>(Ks + jj * pitch + ocol));
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kMaxUq; ++u) {
    const int t = threadIdx.x + u * kThreads;
    if (t < otiles) {
      const int orow = 4 * (t / D4), ocol = 4 * (t % D4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (orow + r < rows) {
          T* out = dq + ((static_cast<long long>(b) * p.Sq + q0 + orow + r) * p.H + h) * D + ocol;
#pragma unroll
          for (int c = 0; c < 4; ++c) store(out + c, acc[u][r][c] * p.scale);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (c) dk and dv
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dO, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                int K, Problem p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, pitch = D + 4;
  float* Ks = smem;                // [kTk][pitch]
  float* Vs = Ks + kTk * pitch;    // [kTk][pitch]
  float* Qs = Vs + kTk * pitch;    // q * scale: [kTq][pitch]
  float* dOs = Qs + kTq * pitch;   // [kTq][pitch]
  float* Ps = dOs + kTq * pitch;   // probabilities, query-major: [kTq][kPk]
  float* dUs = Ps + kTq * kPk;     // du, query-major: [kTq][kPk]
  float* rl = dUs + kTq * kPk;     // lse of the query tile's rows
  float* rd = rl + kTq;            // delta of the query tile's rows

  const int j0 = blockIdx.x * kTk;  // the first key tiles see the most queries
  const int g = blockIdx.y, b = blockIdx.z;
  const int keys = min(kTk, p.Skv - j0);
  load_rows(Ks, k + b * p.ks.b + g * p.ks.h, p.ks.s, j0, kTk, p.Skv, D, pitch, 1.0f);
  load_rows(Vs, v + b * p.vs.b + g * p.vs.h, p.vs.s, j0, kTk, p.Skv, D, pitch, 1.0f);

  // the queries [i_begin, i_end) that may see a key of [j0, j0 + keys)
  int i_begin = 0, i_end = p.Sq;
  if (p.causal) {
    i_begin = j0 / kTq * kTq;
    if (p.window > 0) i_end = min(p.Sq, j0 + keys - 1 + p.window);
  }

  const int rq = threadIdx.x / 8, ck = threadIdx.x % 8;
  const int D4 = D / 4, ktiles = 8 * D4;
  float acc_dk[kMaxUk][4][4], acc_dv[kMaxUk][4][4];
#pragma unroll
  for (int u = 0; u < kMaxUk; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc_dk[u][r][c] = acc_dv[u][r][c] = 0.0f;

  for (int hh = 0; hh < p.rep; ++hh) {
    const int h = g * p.rep + hh;
    const T* qb = q + b * p.qs.b + h * p.qs.h;
    const T* dob = dO + b * p.dos.b + h * p.dos.h;
    const long long stat0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
    for (int q0 = i_begin; q0 < i_end; q0 += kTq) {
      __syncthreads();  // the previous step has finished reading Qs, dOs, Ps and dUs
      load_rows(Qs, qb, p.qs.s, q0, kTq, p.Sq, D, pitch, p.scale);
      load_rows(dOs, dob, p.dos.s, q0, kTq, p.Sq, D, pitch, 1.0f);
      for (int r = threadIdx.x; r < kTq; r += kThreads) {
        const bool in = q0 + r < p.Sq;
        rl[r] = in ? lse[stat0 + q0 + r] : 0.0f;
        rd[r] = in ? delta[stat0 + q0 + r] : 0.0f;
      }
      __syncthreads();
      float s[2][4] = {}, dp[2][4] = {};
      score_tile(s, Qs, Ks, rq, ck, D, pitch);
      score_tile(dp, dOs, Vs, rq, ck, D, pitch);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rq + 32 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = ck + 8 * c;
          float pr = 0.0f, du = 0.0f;
          if (is_valid(q0 + row, j0 + key, p)) {
            float t;
            const float x = capped(s[r][c], p.softcap, &t);
            pr = expf(x - rl[row]);
            du = pr * (dp[r][c] - rd[row]) * (1.0f - t * t);
          }
          Ps[row * kPk + key] = pr;
          dUs[row * kPk + key] = du;
        }
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kMaxUk; ++u) {
        const int t = threadIdx.x + u * kThreads;
        if (t < ktiles) {
          const int krow = 4 * (t / D4), ocol = 4 * (t % D4);
#pragma unroll 4
          for (int ii = 0; ii < kTq; ++ii) {
            fma44(acc_dv[u], *reinterpret_cast<const float4*>(Ps + ii * kPk + krow),
                  *reinterpret_cast<const float4*>(dOs + ii * pitch + ocol));
            fma44(acc_dk[u], *reinterpret_cast<const float4*>(dUs + ii * kPk + krow),
                  *reinterpret_cast<const float4*>(Qs + ii * pitch + ocol));
          }
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kMaxUk; ++u) {
    const int t = threadIdx.x + u * kThreads;
    if (t < ktiles) {
      const int krow = 4 * (t / D4), ocol = 4 * (t % D4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (krow + r < keys) {
          const long long off = ((static_cast<long long>(b) * p.Skv + j0 + krow + r) * K + g) * D + ocol;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            store(dk + off + c, acc_dk[u][r][c]);
            store(dv + off + c, acc_dv[u][r][c]);
          }
        }
      }
    }
  }
}

size_t stats_smem(int D) {
  return sizeof(float) * (static_cast<size_t>(kTq + 2 * kTk) * (D + 4) + kTk * kPq + kTq);
}

size_t dq_smem(int D) {
  return sizeof(float) * (static_cast<size_t>(2 * kTq + 2 * kTk) * (D + 4) + kTk * kPq + 2 * kTq);
}

size_t dkdv_smem(int D) {
  return sizeof(float) * (static_cast<size_t>(2 * kTk + 2 * kTq) * (D + 4) + 2 * kTq * kPk + 2 * kTq);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dO, void* dq, void* dk,
           void* dv, float* lse, float* delta, int batch, int K, const Problem& p,
           cudaStream_t stream) {
  const size_t sa = stats_smem(p.D), sb = dq_smem(p.D), sc = dkdv_smem(p.D);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(sa))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(sb))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bwd_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(sc))) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dO);
  const int nq = (p.Sq + kTq - 1) / kTq, nk = (p.Skv + kTk - 1) / kTk;
  bwd_stats_kernel<T><<<dim3(nq, p.H, batch), kThreads, sa, stream>>>(qt, kt, vt, dot, lse, delta, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dq_kernel<T><<<dim3(nq, p.H, batch), kThreads, sb, stream>>>(qt, kt, vt, dot, lse, delta,
                                                                   static_cast<T*>(dq), p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_kernel<T><<<dim3(nk, K, batch), kThreads, sc, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), K, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* dO, void* dq, void* dk, void* dv,
    void* lse, void* delta, int batch, int Sq, int Skv, int H, int K, int D, int bf16,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, float scale, float softcap, int causal, int window,
    void* stream) {
  if (D <= 0 || D % 32 || D > kMaxD || K <= 0 || H % K || batch <= 0 || Sq <= 0 || Skv <= 0 ||
      batch > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Problem p{Sq, Skv, H, H / K, D,
                  Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
                  Strides{v_sb, v_ss, v_sh}, Strides{do_sb, do_ss, do_sh},
                  scale, softcap, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(delta);
  if (bf16) return launch<__nv_bfloat16>(q, k, v, dO, dq, dk, dv, l, d, batch, K, p, st);
  return launch<float>(q, k, v, dO, dq, dk, dv, l, d, batch, K, p, st);
}
