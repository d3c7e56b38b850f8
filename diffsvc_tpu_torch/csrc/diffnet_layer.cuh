// One gated residual layer of DiffNet as two tiled SIMT kernels: the single
// residual block (K6, diffnet_block.cu), on no path of the JAX package.
// K1, K2 and the training stack (K4, K5) run their layers on the tensor
// cores (diffnet_layer_tc.cuh, diffnet_layer_tf32x3.cuh,
// diffnet_train_bwd.cuh).  With dilation d, everything in the dtype T:
//   y = x + sb                         (rounded to T)
//   z = y[t-d] W0 + y[t] W1 + y[t+d] W2 + bd + cond   (zeros outside [0,T))
//   h = sigmoid(z[:C]) * tanh(z[C:])   (rounded to T)
//   o = h wo + bo
//
// gate_kernel runs the three dilated taps as one GEMM with K = 3C, the gate
// and filter columns of a channel in the same thread, so the gated product
// never leaves registers; block_out_kernel runs the 1x1 output projection
// with K6's epilogue.  Products are f32 FMAs on the CUDA cores (true f32
// for f32 operands, exact products of bf16 values for bf16).
#pragma once

#include "common.cuh"

// Internal linkage: both .cu files include this header and link into one
// library.
namespace {

using dsvc::from_f;
using dsvc::rnd;
using dsvc::to_f;

constexpr int BM = 64;   // rows (b, t) per block
constexpr int BN = 32;   // output channels per block (per column half)
constexpr int BK = 16;   // contraction tile
constexpr int NT = 256;  // 16 x 16 threads: 4 rows x 2 columns each

template <typename T>
__global__ void __launch_bounds__(NT)
gate_kernel(const T* __restrict__ x, const T* __restrict__ sb, long long sb_b,
            const T* __restrict__ cond, const T* __restrict__ wd,
            const T* __restrict__ bd, T* __restrict__ h, int B, int T_, int C,
            int d) {
  __shared__ float As[BK][BM];
  __shared__ float Bg[BK][BN];
  __shared__ float Bf[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int rows = B * T_, K = 3 * C, C2 = 2 * C;
  float ag[4][2] = {}, af[4][2] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int m = e / BK, kk = e % BK, r = m0 + m, k = k0 + kk;
      float v = 0.f;
      if (r < rows && k < K) {
        const int tap = k / C, c = k - tap * C;
        const int b = r / T_, t = r - b * T_, ts = t + (tap - 1) * d;
        if (ts >= 0 && ts < T_)
          v = rnd<T>(to_f(x[((long long)b * T_ + ts) * C + c]) +
                      to_f(sb[b * sb_b + c]));
      }
      As[kk][m] = v;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = e / BN, n = e % BN, k = k0 + kk, o = n0 + n;
      const bool ok = k < K && o < C;
      Bg[kk][n] = ok ? to_f(wd[(long long)k * C2 + o]) : 0.f;
      Bf[kk][n] = ok ? to_f(wd[(long long)k * C2 + C + o]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], g[2], f[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        g[j] = Bg[kk][tx * 2 + j];
        f[j] = Bf[kk][tx * 2 + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          ag[i][j] = fmaf(a[i], g[j], ag[i][j]);
          af[i][j] = fmaf(a[i], f[j], af[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o = n0 + tx * 2 + j;
      if (o >= C) continue;
      const long long cr = (long long)r * C2;
      const float zg = ag[i][j] + to_f(bd[o]) + to_f(cond[cr + o]);
      const float zf = af[i][j] + to_f(bd[C + o]) + to_f(cond[cr + C + o]);
      h[(long long)r * C + o] = from_f<T>(dsvc::sigmoidf_(zg) * tanhf(zf));
    }
  }
}

// The output projection's two column halves for one 64 x 32 tile: ar[i][j]
// = sum_k h[m0 + 4 ty + i, k] wo[k, n0 + 2 tx + j] (residual half) and as
// the same with wo[k, C + ...] (skip half); f32 accumulation.
template <typename OT>
__device__ __forceinline__ void out_gemm(const OT* __restrict__ h,
                                         const OT* __restrict__ wo, int rows,
                                         int C, int m0, int n0,
                                         float (&ar)[4][2], float (&as)[4][2]) {
  __shared__ float As[BK][BM];
  __shared__ float Br[BK][BN];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int C2 = 2 * C;
  for (int k0 = 0; k0 < C; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int m = e / BK, kk = e % BK, r = m0 + m, k = k0 + kk;
      As[kk][m] = (r < rows && k < C) ? to_f(h[(long long)r * C + k]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = e / BN, n = e % BN, k = k0 + kk, o = n0 + n;
      const bool ok = k < C && o < C;
      Br[kk][n] = ok ? to_f(wo[(long long)k * C2 + o]) : 0.f;
      Bs[kk][n] = ok ? to_f(wo[(long long)k * C2 + C + o]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], p[2], q[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        p[j] = Br[kk][tx * 2 + j];
        q[j] = Bs[kk][tx * 2 + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          ar[i][j] = fmaf(a[i], p[j], ar[i][j]);
          as[i][j] = fmaf(a[i], q[j], as[i][j]);
        }
    }
    __syncthreads();
  }
}

// The single residual block's epilogue (K6, diffnet_block.cu): everything
// in T, rounded where the TPU kernel rounds with .astype(x.dtype):
// x_out = rnd(rnd(x + rnd(o[:C])) * rnd(1/sqrt2)) (the Python scalar takes
// x's dtype, as a weak-typed constant does in JAX), skip = rnd(o[C:]) per
// layer.  x is read, x_out written (no in-place update).
template <typename T>
__global__ void __launch_bounds__(NT)
block_out_kernel(const T* __restrict__ h, const T* __restrict__ wo,
                 const T* __restrict__ bo, const T* __restrict__ x,
                 T* __restrict__ x_out, T* __restrict__ skip, int rows,
                 int C) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float ar[4][2] = {}, as[4][2] = {};
  out_gemm(h, wo, rows, C, m0, n0, ar, as);
  const float inv_sqrt2 = rnd<T>(0.7071067811865476f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o = n0 + tx * 2 + j;
      if (o >= C) continue;
      const long long idx = (long long)r * C + o;
      const float res = rnd<T>(ar[i][j] + to_f(bo[o]));
      x_out[idx] = from_f<T>(rnd<T>(to_f(x[idx]) + res) * inv_sqrt2);
      skip[idx] = from_f<T>(as[i][j] + to_f(bo[C + o]));
    }
  }
}

}  // namespace
