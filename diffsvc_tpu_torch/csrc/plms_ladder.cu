// Sampling-ladder kernels (K2) for Hopper: the per-evaluation input
// projection and the fused epilogue (skip/output projections + the
// 12-scalar PLMS / DPM-Solver++(2M) update).
//
// Replaces diffsvc_tpu/ops/pallas/plms_ladder.py:plms_ladder (kernel
// _ladder_kernel).  On the TPU the whole ladder is one kernel with the
// [T, C] state resident in VMEM; at production T that state (1024 x 384
// bf16 = 768 KB) does not fit one SM's 227 KB of shared memory, so here a
// host loop over the J evaluations launches, per evaluation:
//   in_proj_kernel    act = relu(x_eval W_in + b_in)          (this file)
//   K1's layer kernels on act with step-bias row j         (diffnet_stack.cu)
//   epilogue_kernel   eps = relu(skip/sqrt(L) W_skip + b) W_out + b_out,
//                     then g = clip(p x_eval + q eps); f = e0 x_eval + e1 g;
//                     n = w0 f + w1 h0 + w2 h1 + w3 h2; x_next = u x + v n;
//                     x_eval <- x_next; x <- sel ? x_next : x;
//                     (h0,h1,h2) <- push ? (f,h0,h1) : (h0,h1,h2)  (this file)
// The per-evaluation scalars are read from a [J, 12] f32 device table, so
// the loop never syncs with the host.  Sampler state stays f32.
//
// Both kernels are row-block kernels: a block owns R rows, keeps them in
// shared memory, and each thread produces one output column for all R rows
// (weights read coalesced, shared rows broadcast).  Bound on the H100: the
// epilogue's two products are ~0.5 GFLOP per evaluation at T=1024, C=384,
// M=128 on the CUDA cores; both are small next to K1's ~48 GFLOP.
#include "common.cuh"

namespace {

using dsvc::from_f;
using dsvc::rnd;
using dsvc::to_f;

constexpr int R = 8;     // rows per block
constexpr int NT = 128;  // threads per block

template <typename T>
__global__ void __launch_bounds__(NT)
in_proj_kernel(const float* __restrict__ xe, T* __restrict__ act,
               const T* __restrict__ win, const T* __restrict__ bin, int rows,
               int M, int C) {
  extern __shared__ float sx[];  // [R][M] x_eval rows, rounded to T
  const int r0 = blockIdx.x * R;
  for (int e = threadIdx.x; e < R * M; e += NT) {
    const int r = e / M, m = e % M;
    sx[e] = (r0 + r < rows) ? rnd<T>(xe[(long long)(r0 + r) * M + m]) : 0.f;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < C; o += NT) {
    float acc[R] = {};
    for (int k = 0; k < M; ++k) {
      const float w = to_f(win[(long long)k * C + o]);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(sx[r * M + k], w, acc[r]);
    }
    const float b = to_f(bin[o]);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r0 + r < rows)
        act[(long long)(r0 + r) * C + o] = from_f<T>(fmaxf(acc[r] + b, 0.f));
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
epilogue_kernel(const float* __restrict__ skip, const T* __restrict__ wskip,
                const T* __restrict__ bskip, const T* __restrict__ wout,
                const T* __restrict__ bout, const float* __restrict__ sc,
                float* __restrict__ x, float* __restrict__ xe,
                float* __restrict__ hist, int rows, int C, int M, int L,
                float clip_v) {
  extern __shared__ float sm[];
  float* sk = sm;          // [R][C] skip / sqrt(L), rounded to T
  float* s1 = sm + R * C;  // [R][C] relu(sk W_skip + b), rounded to T
  const int r0 = blockIdx.x * R;
  const float inv_sqrt_l = (float)(1.0 / sqrt((double)L));
  for (int e = threadIdx.x; e < R * C; e += NT) {
    const int r = e / C, c = e % C;
    sk[e] = (r0 + r < rows)
                ? rnd<T>(skip[(long long)(r0 + r) * C + c] * inv_sqrt_l)
                : 0.f;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < C; o += NT) {
    float acc[R] = {};
    for (int k = 0; k < C; ++k) {
      const float w = to_f(wskip[(long long)k * C + o]);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(sk[r * C + k], w, acc[r]);
    }
    const float b = to_f(bskip[o]);
#pragma unroll
    for (int r = 0; r < R; ++r) s1[r * C + o] = rnd<T>(fmaxf(acc[r] + b, 0.f));
  }
  __syncthreads();
  const float p = sc[0], q = sc[1], e0 = sc[2], e1 = sc[3];
  const float w0 = sc[4], w1 = sc[5], w2 = sc[6], w3 = sc[7];
  const float u = sc[8], v = sc[9], sel = sc[10], push = sc[11];
  const long long plane = (long long)rows * M;
  for (int m = threadIdx.x; m < M; m += NT) {
    float acc[R] = {};
    for (int k = 0; k < C; ++k) {
      const float w = to_f(wout[(long long)k * M + m]);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(s1[r * C + k], w, acc[r]);
    }
    const float b = to_f(bout[m]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r0 + r >= rows) continue;
      const long long i = (long long)(r0 + r) * M + m;
      const float eps = acc[r] + b;
      const float xev = xe[i];
      float g = p * xev + q * eps;
      if (clip_v > 0.f) g = fminf(fmaxf(g, -clip_v), clip_v);
      const float f = e0 * xev + e1 * g;
      const float h0 = hist[i], h1 = hist[plane + i], h2 = hist[2 * plane + i];
      const float n = w0 * f + w1 * h0 + w2 * h1 + w3 * h2;
      const float xc = x[i];
      const float xn = u * xc + v * n;
      xe[i] = xn;
      x[i] = xc + sel * (xn - xc);
      hist[2 * plane + i] = h2 + push * (h1 - h2);
      hist[plane + i] = h1 + push * (h0 - h1);
      hist[i] = h0 + push * (f - h0);
    }
  }
}

// Opt in to more than 48 KB of dynamic shared memory when a shape needs it.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" {

// xe [rows, M] f32 -> act [rows, C] (compute dtype); win [M, C], bin [C].
int dsvc_ladder_in_proj(int dtype, const void* xe, void* act, const void* win,
                        const void* bin, int rows, int M, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + R - 1) / R);
  const size_t smem = sizeof(float) * R * M;
  if (dtype == DSVC_BF16) {
    using T_ = __nv_bfloat16;
    int e = allow_smem(in_proj_kernel<T_>, smem);
    if (e) return e;
    in_proj_kernel<T_><<<grid, NT, smem, s>>>(
        static_cast<const float*>(xe), static_cast<T_*>(act),
        static_cast<const T_*>(win), static_cast<const T_*>(bin), rows, M, C);
  } else {
    int e = allow_smem(in_proj_kernel<float>, smem);
    if (e) return e;
    in_proj_kernel<float><<<grid, NT, smem, s>>>(
        static_cast<const float*>(xe), static_cast<float*>(act),
        static_cast<const float*>(win), static_cast<const float*>(bin), rows,
        M, C);
  }
  DSVC_LAUNCH_CHECK();
  return 0;
}

// skip [rows, C] f32; wskip [C, C], bskip [C], wout [C, M], bout [M] in the
// compute dtype; sc = this evaluation's 12 scalars; x, xe [rows, M] and
// hist [3, rows, M] f32 sampler state, updated in place.
int dsvc_ladder_epilogue(int dtype, const void* skip, const void* wskip,
                         const void* bskip, const void* wout, const void* bout,
                         const void* sc, void* x, void* xe, void* hist,
                         int rows, int C, int M, int L, float clip_v,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + R - 1) / R);
  const size_t smem = sizeof(float) * 2 * R * C;
  if (dtype == DSVC_BF16) {
    using T_ = __nv_bfloat16;
    int e = allow_smem(epilogue_kernel<T_>, smem);
    if (e) return e;
    epilogue_kernel<T_><<<grid, NT, smem, s>>>(
        static_cast<const float*>(skip), static_cast<const T_*>(wskip),
        static_cast<const T_*>(bskip), static_cast<const T_*>(wout),
        static_cast<const T_*>(bout), static_cast<const float*>(sc),
        static_cast<float*>(x), static_cast<float*>(xe),
        static_cast<float*>(hist), rows, C, M, L, clip_v);
  } else {
    int e = allow_smem(epilogue_kernel<float>, smem);
    if (e) return e;
    epilogue_kernel<float><<<grid, NT, smem, s>>>(
        static_cast<const float*>(skip), static_cast<const float*>(wskip),
        static_cast<const float*>(bskip), static_cast<const float*>(wout),
        static_cast<const float*>(bout), static_cast<const float*>(sc),
        static_cast<float*>(x), static_cast<float*>(xe),
        static_cast<float*>(hist), rows, C, M, L, clip_v);
  }
  DSVC_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
