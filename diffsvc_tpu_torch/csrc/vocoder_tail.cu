// (NSF-)HiFiGAN generator tail (K3) for Hopper: fused Conv1d and fused
// ConvTranspose1d on channels-last [B, T, C] f32 activations.
//
// Replaces diffsvc_tpu/ops/pallas/vocoder_tail.py:tail (kernel from
// _make_kernel).  The TPU kernel runs every stage from the first 128-channel
// stage through conv_post in one time-tiled program over a 128-lane packed
// layout.  Here the same plan is a host loop of two kernels on the plain
// [B, T, C] layout (no lane packing):
//   conv1d_kernel   y = conv(leaky(x, slope); dilation d, padding p) + bias
//                   [+ residual] [tanh]; written to out, or accumulated into
//                   a branch sum acc = (first ? 0 : acc) + y, divided by the
//                   branch count after the last branch (the resblock mean)
//   convt1d_kernel  y = conv_transpose(leaky(x, 0.1); stride u,
//                   padding (k-u)/2) + bias [+ NSF injection]
// Every launch reads zeros outside [0, T) of its own input, which is the
// per-conv re-zeroing the TPU kernel does by hand at the sequence ends.
//
// Both are shared-memory tiled SIMT GEMMs (rows = (b, t), columns = output
// channels, contraction = taps x input channels) with f32 accumulation.
// The transposed conv is split by output phase (t + pad) mod u, so each
// block runs a dense GEMM over the ceil(k/u) taps of its phase.  Bound on
// the H100: arithmetic on the CUDA cores (~200 GFLOP for 5 s of 44.1 kHz
// audio at the openvpi geometry); tensor cores are later work.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 32, BK = 16, NT = 256;

__device__ __forceinline__ float leaky(float v, float slope) {
  return v > 0.f ? v : v * slope;
}

__global__ void __launch_bounds__(NT)
conv1d_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ out,
              const float* __restrict__ res, float* __restrict__ acc,
              int acc_first, float acc_div, int B, int T, int Cin, int Cout,
              int K, int dil, int pad, float slope, int use_act,
              int use_tanh) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int rows = B * T, KD = K * Cin;
  float a[4][2] = {};
  for (int k0 = 0; k0 < KD; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int m = e / BK, kk = e % BK, r = m0 + m, k = k0 + kk;
      float v = 0.f;
      if (r < rows && k < KD) {
        const int j = k / Cin, c = k - j * Cin;
        const int b = r / T, t = r - b * T, ti = t + j * dil - pad;
        if (ti >= 0 && ti < T) {
          v = x[((long long)b * T + ti) * Cin + c];
          if (use_act) v = leaky(v, slope);
        }
      }
      As[kk][m] = v;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = e / BN, n = e % BN, k = k0 + kk, o = n0 + n;
      Bs[kk][n] = (k < KD && o < Cout) ? w[(long long)k * Cout + o] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 2; ++j) bv[j] = Bs[kk][tx * 2 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) a[i][j] = fmaf(av[i], bv[j], a[i][j]);
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
      if (o >= Cout) continue;
      const long long idx = (long long)r * Cout + o;
      float y = a[i][j] + bias[o];
      if (res) y += res[idx];
      if (use_tanh) y = tanhf(y);
      if (acc) {
        float s = acc_first ? y : acc[idx] + y;
        if (acc_div > 0.f) s = s / acc_div;
        acc[idx] = s;
      } else {
        out[idx] = y;
      }
    }
  }
}

// grid.z = b * u + phase; rows of a block are s = blockIdx.x*BM + m with
// output time t_o = s*u + phase - pad; taps j = phase + u*q, input t = s - q.
__global__ void __launch_bounds__(NT)
convt1d_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ inj,
               int inj_T, float* __restrict__ out, int Tin, int Tout, int Cin,
               int Cout, int K, int u, int pad, float slope) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int s0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int b = blockIdx.z / u, ph = blockIdx.z % u;
  const int nq = (K + u - 1) / u, KD = nq * Cin;
  float a[4][2] = {};
  for (int k0 = 0; k0 < KD; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int m = e / BK, kk = e % BK, k = k0 + kk;
      float v = 0.f;
      if (k < KD) {
        const int q = k / Cin, c = k - q * Cin, ti = s0 + m - q;
        if (ti >= 0 && ti < Tin)
          v = leaky(x[((long long)b * Tin + ti) * Cin + c], slope);
      }
      As[kk][m] = v;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = e / BN, n = e % BN, k = k0 + kk, o = n0 + n;
      float v = 0.f;
      if (k < KD && o < Cout) {
        const int q = k / Cin, c = k - q * Cin, j = ph + u * q;
        if (j < K) v = w[((long long)j * Cin + c) * Cout + o];
      }
      Bs[kk][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 2; ++j) bv[j] = Bs[kk][tx * 2 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) a[i][j] = fmaf(av[i], bv[j], a[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int to = (s0 + ty * 4 + i) * u + ph - pad;
    if (to < 0 || to >= Tout) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o = n0 + tx * 2 + j;
      if (o >= Cout) continue;
      float y = a[i][j] + bias[o];
      if (inj) y += inj[((long long)b * inj_T + to) * Cout + o];
      out[((long long)b * Tout + to) * Cout + o] = y;
    }
  }
}

}  // namespace

extern "C" {

// x [B,T,Cin]; w [K,Cin,Cout]; bias [Cout]; res (optional) [B,T,Cout];
// writes out [B,T,Cout], or accumulates into acc [B,T,Cout] when acc != 0.
int dsvc_tail_conv1d(const void* x, const void* w, const void* bias, void* out,
                     const void* res, void* acc, int acc_first, float acc_div,
                     int B, int T, int Cin, int Cout, int K, int dil, int pad,
                     float slope, int use_act, int use_tanh, void* stream) {
  const dim3 grid((B * T + BM - 1) / BM, (Cout + BN - 1) / BN);
  conv1d_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out),
      static_cast<const float*>(res), static_cast<float*>(acc), acc_first,
      acc_div, B, T, Cin, Cout, K, dil, pad, slope, use_act, use_tanh);
  DSVC_LAUNCH_CHECK();
  return 0;
}

// x [B,Tin,Cin]; w [K,Cin,Cout] (torch ConvTranspose1d weight [Cin,Cout,K]
// permuted); inj (optional) [B,inj_T,Cout] with inj_T >= Tout;
// out [B,Tout,Cout].
int dsvc_tail_convt1d(const void* x, const void* w, const void* bias,
                      const void* inj, int inj_T, void* out, int B, int Tin,
                      int Tout, int Cin, int Cout, int K, int u, int pad,
                      float slope, void* stream) {
  const int n_s = (Tout - 1 + pad) / u + 1;
  const dim3 grid((n_s + BM - 1) / BM, (Cout + BN - 1) / BN, B * u);
  convt1d_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(inj), inj_T,
      static_cast<float*>(out), Tin, Tout, Cin, Cout, K, u, pad, slope);
  DSVC_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
