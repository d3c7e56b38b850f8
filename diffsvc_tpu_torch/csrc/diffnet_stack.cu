// DiffNet residual stack (K1) for Hopper: the L gated residual layers of one
// denoiser evaluation on [B, T, C] activations.
//
// Replaces diffsvc_tpu/ops/pallas/diffnet_stack.py:residual_stack (kernel
// _kernel).  Per layer l, with d = 2^(l mod cycle):
//   y = x + sb_l                       (rounded to the compute dtype)
//   z = y[t-d] W0 + y[t] W1 + y[t+d] W2 + bd + cond_l   (zeros outside [0,T))
//   h = sigmoid(z[:C]) * tanh(z[C:])   (rounded to the compute dtype)
//   o = h wo + bo
//   x <- (x + o[:C]) / sqrt(2)         (rounded to the compute dtype)
//   skip += o[C:]                      (f32)
//
// Two kernels per layer: gate_kernel (the three dilated taps as one GEMM
// with K = 3C, gate and filter columns computed by the same thread so the
// gated product never leaves registers) and out_kernel (the 1x1 output
// projection with the residual update of x in place and the f32 skip sum).
// Both are shared-memory tiled SIMT GEMMs with f32 accumulation; operands
// are f32 or bf16.  What bounds them on the H100: FLOPs on the CUDA cores
// (no tensor cores yet), ~2.4 GFLOP per layer at T=1024, C=384.  wgmma/TMA
// tiles are later work.
#include "common.cuh"

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

template <typename T>
__global__ void __launch_bounds__(NT)
out_kernel(const T* __restrict__ h, const T* __restrict__ wo,
           const T* __restrict__ bo, T* __restrict__ x,
           float* __restrict__ skip, int rows, int C, int first) {
  __shared__ float As[BK][BM];
  __shared__ float Br[BK][BN];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int C2 = 2 * C;
  float ar[4][2] = {}, as[4][2] = {};
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
  const float inv_sqrt2 = 0.7071067811865476f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o = n0 + tx * 2 + j;
      if (o >= C) continue;
      const long long idx = (long long)r * C + o;
      const float res = ar[i][j] + to_f(bo[o]);
      const float sk = as[i][j] + to_f(bo[C + o]);
      x[idx] = from_f<T>((to_f(x[idx]) + res) * inv_sqrt2);
      skip[idx] = first ? sk : skip[idx] + sk;
    }
  }
}

template <typename T>
int run_stack(T* x, T* h, float* skip, const T* sb, long long sb_l,
              long long sb_b, const T* cond, const T* wd, const T* bd,
              const T* wo, const T* bo, int B, int T_, int C, int L, int cycle,
              cudaStream_t stream) {
  const int rows = B * T_;
  const dim3 grid((rows + BM - 1) / BM, (C + BN - 1) / BN);
  const long long C2 = 2LL * C;
  for (int l = 0; l < L; ++l) {
    const int d = 1 << (l % cycle);
    gate_kernel<T><<<grid, NT, 0, stream>>>(
        x, sb + l * sb_l, sb_b, cond + (long long)l * rows * C2,
        wd + (long long)l * 3 * C * C2, bd + l * C2, h, B, T_, C, d);
    DSVC_LAUNCH_CHECK();
    out_kernel<T><<<grid, NT, 0, stream>>>(h, wo + (long long)l * C * C2,
                                           bo + l * C2, x, skip, rows, C,
                                           l == 0);
    DSVC_LAUNCH_CHECK();
  }
  return 0;
}

}  // namespace

extern "C" {

// x [B,T,C] running state (updated in place), h [B,T,C] scratch, skip
// [B,T,C] f32 output; sb [L,B,C] with element strides (sb_l, sb_b), cond
// [L,B,T,2C], wd [L,3,C,2C], bd [L,2C], wo [L,C,2C], bo [L,2C].
int dsvc_residual_stack(int dtype, void* x, void* h, void* skip,
                        const void* sb, long long sb_l, long long sb_b,
                        const void* cond, const void* wd, const void* bd,
                        const void* wo, const void* bo, int B, int T, int C,
                        int L, int cycle, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DSVC_BF16) {
    using T_ = __nv_bfloat16;
    return run_stack<T_>(static_cast<T_*>(x), static_cast<T_*>(h),
                         static_cast<float*>(skip), static_cast<const T_*>(sb),
                         sb_l, sb_b, static_cast<const T_*>(cond),
                         static_cast<const T_*>(wd), static_cast<const T_*>(bd),
                         static_cast<const T_*>(wo), static_cast<const T_*>(bo),
                         B, T, C, L, cycle, s);
  }
  return run_stack<float>(static_cast<float*>(x), static_cast<float*>(h),
                          static_cast<float*>(skip),
                          static_cast<const float*>(sb), sb_l, sb_b,
                          static_cast<const float*>(cond),
                          static_cast<const float*>(wd),
                          static_cast<const float*>(bd),
                          static_cast<const float*>(wo),
                          static_cast<const float*>(bo), B, T, C, L, cycle, s);
}

const char* dsvc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
