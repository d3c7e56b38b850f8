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
// What bounds it on the H100: arithmetic, ~2.4 GFLOP per layer at T=1024,
// C=384.  Both dtypes run on the tensor cores, two wgmma kernels per layer
// over packed weights and a staged y: bf16 (the TPU kernel's only dtype,
// and the serving mode) with bf16 operands (diffnet_layer_tc.cuh, whose
// note gives the design); f32 (no TPU counterpart; the default config's
// dtype) as 3xTF32 split products that keep f32 accuracy
// (diffnet_layer_tf32x3.cuh).
#include "diffnet_layer_tf32x3.cuh"

extern "C" {

// x [B,T,C] running state (updated in place), skip [B,T,C] f32 output; sb
// [L,B,C] with element strides (sb_l, sb_b), cond [L,B,T,2C], bd [L,2C],
// bo [L,2C]; plan the wrapper's launch plan (tc::P_* fields).  bf16: h and
// y [B,T,Cp] scratch with zero pad channels, wd and wo packed by the
// wrapper ([L,2Cp,3Cp] and [L,2Cp,Cp]).  f32: h and y [2,B,T,Cp] hi and lo
// planes with zero pad channels, wd and wo packed and split by the wrapper
// ([L,2,2Cp,3Cp] and [L,2,2Cp,Cp]).
int dsvc_residual_stack(int dtype, void* x, void* h, void* skip,
                        const void* sb, long long sb_l, long long sb_b,
                        const void* cond, const void* wd, const void* bd,
                        const void* wo, const void* bo, int B, int T, int C,
                        int L, int cycle, void* y, const int* plan,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DSVC_BF16) {
    using T_ = __nv_bfloat16;
    if (!tc::plan_ok(plan, T, C, 0)) return cudaErrorInvalidValue;
    const int e = tc::prepare_layers(plan);
    if (e != 0) return e;
    return tc::run_stack_tc(
        static_cast<T_*>(x), static_cast<T_*>(y), static_cast<T_*>(h),
        static_cast<float*>(skip), static_cast<const T_*>(sb), sb_l, sb_b,
        static_cast<const T_*>(cond), static_cast<const T_*>(wd),
        static_cast<const T_*>(bd), static_cast<const T_*>(wo),
        static_cast<const T_*>(bo), B, T, C, L, cycle, false, plan, s);
  }
  if (!tf32x3::plan_ok(plan, T, C, 0)) return cudaErrorInvalidValue;
  const int e = tf32x3::prepare_layers(plan);
  if (e != 0) return e;
  return tf32x3::run_stack(
      static_cast<float*>(x), static_cast<float*>(y), static_cast<float*>(h),
      static_cast<float*>(skip), static_cast<const float*>(sb), sb_l, sb_b,
      static_cast<const float*>(cond), static_cast<const float*>(wd),
      static_cast<const float*>(bd), static_cast<const float*>(wo),
      static_cast<const float*>(bo), B, T, C, L, cycle, false, 0.f, plan, s);
}

const char* dsvc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
