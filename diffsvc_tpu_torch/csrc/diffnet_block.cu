// One gated residual block of DiffNet (K6) on Hopper.
//
// Replaces diffsvc_tpu/ops/pallas/diffnet_block.py:fused_residual_block
// (kernel _make_kernel): x [B,T,C], step [B,C], cond [B,T,2C], wd [3,C,2C],
// bd [2C], wo [C,2C], bo [2C] -> (x_out, skip), both [B,T,C] in x's dtype:
//   y = rnd(x + step)                                (broadcast over T)
//   z = y[t-d] W0 + y[t] W1 + y[t+d] W2 + bd + cond  (zeros outside [0,T))
//   h = rnd(sigmoid(z[:C]) * tanh(z[C:]))
//   o = h wo + bo
//   x_out = rnd(rnd(x + rnd(o[:C])) * rnd(1/sqrt2)),  skip = rnd(o[C:])
// where rnd rounds to x's dtype at the TPU kernel's .astype points (unlike
// K1, which adds the residual in f32 and sums skip in f32 over layers).
// The TPU kernel pads y by d on both ends and asserts T % tile == 0; here
// the taps read t +- d with zeros outside [0, T), for any T.
//
// Two launches: diffnet_layer.cuh's gate_kernel (all operands in x's dtype,
// the step as a per-sample bias) and block_out_kernel.  What bounds it on
// the H100: in f32, FLOPs (16 C^2 per row: ~2.4 GFLOP at T=1024, C=384) on
// the CUDA cores; in bf16 the operation count over the tensor-core peak is
// below the bytes' time, but these SIMT tiles run far from either bound.
#include "diffnet_layer.cuh"

extern "C" {

// h [B*T, C] scratch in x's dtype; x_out and skip [B,T,C] outputs.
int dsvc_residual_block(int dtype, const void* x, const void* step,
                        const void* cond, const void* wd, const void* bd,
                        const void* wo, const void* bo, void* h, void* x_out,
                        void* skip, int B, int T, int C, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B * T + BM - 1) / BM, (C + BN - 1) / BN);
  if (dtype == DSVC_BF16) {
    using T_ = __nv_bfloat16;
    gate_kernel<T_><<<grid, NT, 0, s>>>(
        static_cast<const T_*>(x), static_cast<const T_*>(step), C,
        static_cast<const T_*>(cond), static_cast<const T_*>(wd),
        static_cast<const T_*>(bd), static_cast<T_*>(h), B, T, C, d);
    DSVC_LAUNCH_CHECK();
    block_out_kernel<T_><<<grid, NT, 0, s>>>(
        static_cast<const T_*>(h), static_cast<const T_*>(wo),
        static_cast<const T_*>(bo), static_cast<const T_*>(x),
        static_cast<T_*>(x_out), static_cast<T_*>(skip), B * T, C);
    DSVC_LAUNCH_CHECK();
    return 0;
  }
  if (dtype != DSVC_F32) return static_cast<int>(cudaErrorInvalidValue);
  gate_kernel<float><<<grid, NT, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(step), C,
      static_cast<const float*>(cond), static_cast<const float*>(wd),
      static_cast<const float*>(bd), static_cast<float*>(h), B, T, C, d);
  DSVC_LAUNCH_CHECK();
  block_out_kernel<float><<<grid, NT, 0, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(wo),
      static_cast<const float*>(bo), static_cast<const float*>(x),
      static_cast<float*>(x_out), static_cast<float*>(skip), B * T, C);
  DSVC_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
