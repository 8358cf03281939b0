// Mamba-2's depthwise causal conv1d with its bias and SiLU, forward and
// backward, for Hopper (sm_90a), bound with a plain C interface and loaded
// through ctypes by repro_torch/kernels/causal_conv.py (CausalConvFn).
//
// Replaces no TPU kernel: the reference computes the convolution as K
// shifted products in plain JAX (repro/models/ssm.py _causal_conv) and
// trains through it with jax.grad. This is
//   y[t, c] = silu(b[c] + sum_k w[k, c] x[t - (K - 1) + k, c])
// over each batch row's sequence, x[t] = 0 before t = 0, and its gradient.
//
// Bound: device memory. The forward reads x and writes y, 2 bytes an
// element each, against 2K + 4 operations an element; the backward reads x
// and dy and writes dx (6 bytes an element) against about 6K + 9. The
// plain version (K products, each rounded to bf16, then the bias and SiLU,
// and autograd's per-tap gradients) makes about 30 passes over such a
// tensor in a forward and backward; these kernels make 5.
//
// Design: x is read in place, a (B, S, C) view with any batch and row
// stride (the x|B|C columns of in_proj's output), its channels contiguous.
// A thread owns 4 adjacent channels, moved as one 8-byte vector, over a run
// of timesteps; the 32 lanes of a warp cover 128 adjacent channels of one
// row, so a warp's load is one contiguous 256-byte segment, and the 4 warps
// of a block take 4 consecutive runs of the same channels. w and b for the
// thread's channels stay in registers, the last K - 1 inputs slide through
// registers, so each row is read once (a run's first K - 1 rows again, from
// L2, as its neighbour's last), and a thread starts the loads of 4 rows
// before it uses the first. Everything is summed in f32 and rounded to
// bf16 once; the sigmoid takes the hardware's exp2 and reciprocal (each
// within 2 ulp of f32, far inside y's rounding to bf16). Timed on an H100
// (chip_smoke.py's conv phase): 4 channels a thread beat 8 (16-byte
// vectors, but the backward's registers left half the warps resident) and
// 2, and 4-warp blocks beat 8-warp ones.
//
// The backward recomputes the pre-activation from x, w and b (nothing but
// them is saved), g = dy silu'(pre), and dx[t] = sum_k w[k] g[t + K-1-k],
// reading K - 1 rows past its run (g of the next run's first rows, zero
// past the sequence's end). Each thread sums its run's share of dw and db
// in registers; the block adds its warps' shares in shared memory, in
// order, into one partial per (batch row, run of the block); a second
// launch adds the partials of each group of batch rows in order. No
// atomics: the same inputs give the same bits.
//
// w and b are read per batch row at a stride (0: one for all rows; K C and
// C: a row each, the peers of a vmapped banked step folded into the batch).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kLanes = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kLanes * kWarps;
constexpr int kVec = 4;  // channels a thread
constexpr int kTile = kLanes * kVec;  // channels a block
constexpr int kFwdRun = 32;  // timesteps a thread walks in the forward
constexpr int kBwdRun = 64;  // and in the backward
constexpr int kRows = 4;  // rows whose loads a thread starts together
constexpr int kMaxK = 4;

// 4 bf16 values at p (8-byte aligned), read-only path
__device__ __forceinline__ uint2 load_raw(const bf16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ void unpack(uint2 r, float (&out)[kVec]) {
  out[0] = __uint_as_float(r.x << 16);
  out[1] = __uint_as_float(r.x & 0xffff0000u);
  out[2] = __uint_as_float(r.y << 16);
  out[3] = __uint_as_float(r.y & 0xffff0000u);
}

__device__ __forceinline__ void load_vec(const bf16* p, float (&out)[kVec]) {
  unpack(load_raw(p), out);
}

__device__ __forceinline__ void store_vec(bf16* p, const float (&in)[kVec]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(in[0], in[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(in[2], in[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                            *reinterpret_cast<const uint32_t*>(&hi));
}

// sigmoid(v) = 1 / (1 + e^-v), 0 where e^-v passes 2^126
__device__ __forceinline__ float sigmoid(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}

__device__ __forceinline__ float silu(float v) { return v * sigmoid(v); }

// d silu(v) / dv = s (1 + v (1 - s)), s = sigmoid(v)
__device__ __forceinline__ float silu_grad(float v) {
  const float s = sigmoid(v);
  return s * (1.0f + v * (1.0f - s));
}

struct Geometry {
  int S, C, runs;  // the sequence, the channels, the blocks along a sequence
  long long x_sb, x_ss;  // x's strides (batch, seq) in elements
  long long w_sb, b_sb;  // w's and b's strides between batch rows (0: shared)
};

// w (K rows) and b for the thread's channels of batch row b
template <int K>
__device__ __forceinline__ void load_weights(const bf16* w, const bf16* bias, int b, int c0,
                                             const Geometry& g, float (&wk)[K][kVec],
                                             float (&bb)[kVec]) {
#pragma unroll
  for (int k = 0; k < K; ++k) load_vec(w + b * g.w_sb + static_cast<long long>(k) * g.C + c0, wk[k]);
  load_vec(bias + b * g.b_sb + c0, bb);
}

// Block (run r of batch row b, channel tile): blockIdx.x = b * runs + r.
template <int K>
__global__ void __launch_bounds__(kThreads)
causal_conv_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const bf16* __restrict__ bias, bf16* __restrict__ y, Geometry g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * kTile + lane * kVec;
  const int b = blockIdx.x / g.runs;
  const int t0 = ((blockIdx.x % g.runs) * kWarps + warp) * kFwdRun;
  if (c0 >= g.C || t0 >= g.S) return;
  float wk[K][kVec], bb[kVec];
  load_weights<K>(w, bias, b, c0, g, wk, bb);
  const bf16* xb = x + b * g.x_sb + c0;
  bf16* yb = y + static_cast<long long>(b) * g.S * g.C + c0;
  float win[K][kVec];  // x[t - (K-1) + j]; win[K-1] is the current row
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int t = t0 - (K - 1) + j;
    if (t >= 0) {
      load_vec(xb + t * g.x_ss, win[j]);
    } else {
#pragma unroll
      for (int c = 0; c < kVec; ++c) win[j][c] = 0.0f;
    }
  }
  const int t1 = min(t0 + kFwdRun, g.S);
  for (int t = t0; t < t1; t += kRows) {
    uint2 rows[kRows];  // the next kRows rows' loads, in flight together
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (t + i < t1) rows[i] = load_raw(xb + (t + i) * g.x_ss);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (t + i >= t1) break;
      unpack(rows[i], win[K - 1]);
      float out[kVec];
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        float acc = wk[0][c] * win[0][c];
#pragma unroll
        for (int k = 1; k < K; ++k) acc = fmaf(wk[k][c], win[k][c], acc);
        out[c] = silu(acc + bb[c]);
      }
      store_vec(yb + static_cast<long long>(t + i) * g.C, out);
#pragma unroll
      for (int j = 0; j + 1 < K; ++j) {
#pragma unroll
        for (int c = 0; c < kVec; ++c) win[j][c] = win[j + 1][c];
      }
    }
  }
}

// dx (B, S, C) bf16, and per block the f32 partials of dw (K rows) and db
// (one row) of its channels: part[(blockIdx.x * (K + 1) + k) * C + c].
template <int K>
__global__ void __launch_bounds__(kThreads)
causal_conv_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const bf16* __restrict__ bias, const bf16* __restrict__ dy,
                       bf16* __restrict__ dx, float* __restrict__ part, Geometry g) {
  __shared__ float red[kWarps][K + 1][kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * kTile + lane * kVec;
  const int b = blockIdx.x / g.runs;
  const int t0 = ((blockIdx.x % g.runs) * kWarps + warp) * kBwdRun;
  float dw[K][kVec], db[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    db[c] = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) dw[k][c] = 0.0f;
  }
  if (c0 < g.C && t0 < g.S) {
    float wk[K][kVec], bb[kVec];
    load_weights<K>(w, bias, b, c0, g, wk, bb);
    const bf16* xb = x + b * g.x_sb + c0;
    const long long row0 = static_cast<long long>(b) * g.S;
    const bf16* dyb = dy + row0 * g.C + c0;
    bf16* dxb = dx + row0 * g.C + c0;
    float win[K][kVec];  // x[u - (K-1) + j]
    float gw[K][kVec];   // g[u - (K-1) + j], 0 before t0 (never read there)
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
      const int t = t0 - (K - 1) + j;
#pragma unroll
      for (int c = 0; c < kVec; ++c) gw[j][c] = 0.0f;
      if (t >= 0) {
        load_vec(xb + t * g.x_ss, win[j]);
      } else {
#pragma unroll
        for (int c = 0; c < kVec; ++c) win[j][c] = 0.0f;
      }
    }
    const int tend = min(t0 + kBwdRun, g.S);  // dx rows of this run: [t0, tend)
    const int uend = min(tend + K - 1, g.S);  // g rows it needs: [t0, uend), 0 past S
    for (int u0 = t0; u0 < tend + K - 1; u0 += kRows) {
      uint2 xr[kRows], dr[kRows];  // the next kRows rows' loads, in flight together
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (u0 + i < uend) {
          xr[i] = load_raw(xb + (u0 + i) * g.x_ss);
          dr[i] = load_raw(dyb + static_cast<long long>(u0 + i) * g.C);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int u = u0 + i;
        if (u >= tend + K - 1) break;
        if (u < uend) {
          float d[kVec];
          unpack(xr[i], win[K - 1]);
          unpack(dr[i], d);
          const bool own = u < tend;
#pragma unroll
          for (int c = 0; c < kVec; ++c) {
            float pre = wk[0][c] * win[0][c];
#pragma unroll
            for (int k = 1; k < K; ++k) pre = fmaf(wk[k][c], win[k][c], pre);
            const float gv = d[c] * silu_grad(pre + bb[c]);
            gw[K - 1][c] = gv;
            if (own) {
              db[c] += gv;
#pragma unroll
              for (int k = 0; k < K; ++k) dw[k][c] = fmaf(gv, win[k][c], dw[k][c]);
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < kVec; ++c) {
            gw[K - 1][c] = 0.0f;
            win[K - 1][c] = 0.0f;
          }
        }
        const int s = u - (K - 1);  // dx[s] = sum_k w[k] g[s + K-1-k] = sum_k w[k] gw[K-1-k]
        if (s >= t0) {
          float out[kVec];
#pragma unroll
          for (int c = 0; c < kVec; ++c) {
            float acc = wk[0][c] * gw[K - 1][c];
#pragma unroll
            for (int k = 1; k < K; ++k) acc = fmaf(wk[k][c], gw[K - 1 - k][c], acc);
            out[c] = acc;
          }
          store_vec(dxb + static_cast<long long>(s) * g.C, out);
        }
#pragma unroll
        for (int j = 0; j + 1 < K; ++j) {
#pragma unroll
          for (int c = 0; c < kVec; ++c) {
            win[j][c] = win[j + 1][c];
            gw[j][c] = gw[j + 1][c];
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    red[warp][K][lane * kVec + c] = db[c];
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp][k][lane * kVec + c] = dw[k][c];
  }
  __syncthreads();
  const int tile = blockIdx.y * kTile;
  for (int i = threadIdx.x; i < (K + 1) * kTile; i += kThreads) {
    const int k = i / kTile, cl = i % kTile;
    if (tile + cl >= g.C) continue;
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < kWarps; ++r) sum += red[r][k][cl];
    part[(static_cast<long long>(blockIdx.x) * (K + 1) + k) * g.C + tile + cl] = sum;
  }
}

// out[grp, j] = sum over the group's blocks, in order, of part[blk, j], j
// over the (K + 1) C rows of dw and db: one sum for each of `groups` equal
// runs of the batch.
__global__ void __launch_bounds__(kThreads)
causal_conv_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                          long long per_group, int blocks_per_group, long long n_out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const long long grp = i / per_group, j = i % per_group;
  const float* p = part + grp * blocks_per_group * per_group + j;
  float sum = 0.0f;
  for (int blk = 0; blk < blocks_per_group; ++blk) sum += p[blk * per_group];
  out[i] = sum;
}

dim3 grid_of(int batch, const Geometry& g) {
  return dim3(batch * g.runs, (g.C + kTile - 1) / kTile);
}

template <int K>
int launch_fwd(const bf16* x, const bf16* w, const bf16* b, bf16* y, int batch, const Geometry& g,
               cudaStream_t st) {
  causal_conv_fwd_kernel<K><<<grid_of(batch, g), kThreads, 0, st>>>(x, w, b, y, g);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_bwd(const bf16* x, const bf16* w, const bf16* b, const bf16* dy, bf16* dx, float* part,
               float* out, int batch, int groups, const Geometry& g, cudaStream_t st) {
  causal_conv_bwd_kernel<K><<<grid_of(batch, g), kThreads, 0, st>>>(x, w, b, dy, dx, part, g);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long per_group = static_cast<long long>(K + 1) * g.C;
  const long long n_out = groups * per_group;
  const unsigned blocks = static_cast<unsigned>((n_out + kThreads - 1) / kThreads);
  causal_conv_reduce_kernel<<<blocks, kThreads, 0, st>>>(part, out, per_group,
                                                          (batch / groups) * g.runs, n_out);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int batch, int S, int C, int K, long long w_sb, long long b_sb) {
  return batch > 0 && S > 0 && C > 0 && C % kVec == 0 && K >= 1 && K <= kMaxK &&
         (w_sb == 0 || w_sb == static_cast<long long>(K) * C) && (b_sb == 0 || b_sb == C) &&
         (C + kTile - 1) / kTile <= 65535;
}

int runs_of(int S, int run) { return (S + kWarps * run - 1) / (kWarps * run); }

}  // namespace

extern "C" {

// x (batch, S, C) bf16 at strides (x_sb, x_ss, 1), 8-byte aligned; w (K, C)
// and b (C,) bf16, read per batch row at strides w_sb and b_sb (0 or K C, 0
// or C); y (batch, S, C) bf16 contiguous. Returns the cudaError_t of the
// launch (0 = success).
int causal_conv_fwd_launch(const void* x, const void* w, const void* b, void* y, int batch, int S,
                           int C, int K, long long x_sb, long long x_ss, long long w_sb,
                           long long b_sb, void* stream) {
  if (!valid(batch, S, C, K, w_sb, b_sb)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{S, C, runs_of(S, kFwdRun), x_sb, x_ss, w_sb, b_sb};
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wb = static_cast<const bf16*>(w);
  const auto* bb = static_cast<const bf16*>(b);
  auto* yb = static_cast<bf16*>(y);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch_fwd<1>(xb, wb, bb, yb, batch, g, st);
    case 2: return launch_fwd<2>(xb, wb, bb, yb, batch, g, st);
    case 3: return launch_fwd<3>(xb, wb, bb, yb, batch, g, st);
    default: return launch_fwd<4>(xb, wb, bb, yb, batch, g, st);
  }
}

// dy (batch, S, C) bf16 contiguous -> dx (batch, S, C) bf16 contiguous and
// out (groups, K + 1, C) f32: rows 0..K-1 dw, row K db, each summed over its
// group of batch / groups rows. part: a scratch of batch x ceil(S / 256) x
// (K + 1) x C floats (a block takes 4 warps x 64 steps of a sequence).
int causal_conv_bwd_launch(const void* x, const void* w, const void* b, const void* dy, void* dx,
                           void* part, void* out, int batch, int groups, int S, int C, int K,
                           long long x_sb, long long x_ss, long long w_sb, long long b_sb,
                           void* stream) {
  if (!valid(batch, S, C, K, w_sb, b_sb) || groups <= 0 || batch % groups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{S, C, runs_of(S, kBwdRun), x_sb, x_ss, w_sb, b_sb};
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wb = static_cast<const bf16*>(w);
  const auto* bb = static_cast<const bf16*>(b);
  const auto* dyb = static_cast<const bf16*>(dy);
  auto* dxb = static_cast<bf16*>(dx);
  auto* pf = static_cast<float*>(part);
  auto* of = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch_bwd<1>(xb, wb, bb, dyb, dxb, pf, of, batch, groups, g, st);
    case 2: return launch_bwd<2>(xb, wb, bb, dyb, dxb, pf, of, batch, groups, g, st);
    case 3: return launch_bwd<3>(xb, wb, bb, dyb, dxb, pf, of, batch, groups, g, st);
    default: return launch_bwd<4>(xb, wb, bb, dyb, dxb, pf, of, batch, groups, g, st);
  }
}

}  // extern "C"
