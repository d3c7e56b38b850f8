// Shared helpers for the hand-written Hopper kernels (plain C interface,
// bound with ctypes from diffsvc_tpu_torch/ops/hopper/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dsvc {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bf16)
}

// Round an f32 value through T (identity for float): the compute-dtype
// rounding that the TPU kernels apply with .astype(x.dtype).
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float sigmoidf_(float z) { return 1.f / (1.f + expf(-z)); }

}  // namespace dsvc

// Return the first launch error to the caller (checked by the wrapper).
#define DSVC_LAUNCH_CHECK()                                   \
  do {                                                        \
    cudaError_t e_ = cudaGetLastError();                      \
    if (e_ != cudaSuccess) return static_cast<int>(e_);       \
  } while (0)

enum { DSVC_F32 = 0, DSVC_BF16 = 1 };
