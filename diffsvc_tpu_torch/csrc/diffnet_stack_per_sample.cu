// The DiffNet residual stack's per-sample training backward (K5) on Hopper.
//
// Replaces diffsvc_tpu/ops/pallas/diffnet_stack.py:_call_bwd (kernel
// _bwd_kernel) as jax.vmap runs it over the samples of a batch: the custom
// VJP of residual_stack_train (:442-478), the training route of batches whose
// [B, T, C] dx carry does not fit the batch-fused kernel (K4).  Its forward
// is K4's forward with save at an f32 stream (_call_fwd); this file is the
// backward.
//
// Per sample, _bwd_kernel's math: y and h recomputed from the saved x_l and
// rounded to x_l's dtype, dout taken in f32, dcp stored in f32 without
// rounding (rounded only as a product operand), the dx carry within the
// sample, dx0 written once after the last layer.  vmap's transpose sums the
// per-sample weight and bias grads over the batch; here each sample's grads
// are contracted over that sample's own T rows (chunks of at most rch rows
// that start at its first row) and the samples' sums are added in sample
// order, per layer, without ever holding the [B, L, 3, C, 2C] per-sample
// grads (one [B * chunks, 3C, 2C] partial buffer is reused across layers).
// So K5 at batch B equals, bit for bit, the in-order sum of its B = 1 runs.
// One launch per stage covers the whole batch (diffnet_train_bwd.cuh).
//
// At an f32 stream K5 computes K4's math; only the order of the weight- and
// bias-grad sums differs (per sample, then over samples, against K4's
// chunks of 2048 rows across sample boundaries).  What bounds it on the
// H100: FLOPs, 44 C^2 per row and layer in true f32 on the CUDA cores
// (67 TFLOP/s at most); tensor cores cannot take f32 operands without
// rounding them (TF32), which this route exists to avoid.
#include "diffnet_train_bwd.cuh"

extern "C" {

// In: xsave [L,B,T,C], cond [L,B,T,2C], wd [L,3,C,2C], wo [L,C,2C] (odt, the
// state's dtype), sb [L,B,C] f32 (contiguous), bd [L,2C] f32, dout [B,T,C]
// f32.  Out: dx [B,T,C] (= dx0), dsb [L,B,C], dcp [L,B,T,2C], dwd, dbd,
// dwo, dbo summed over the batch in sample order, all f32.  Scratch as
// run_bwd states with segments of T rows, gsum [B, 2C] f32.
int dsvc_stack_train_bwd_per_sample(
    int odt, const void* xsave, const void* sb, const void* cond,
    const void* wd, const void* bd, const void* wo, const void* dout,
    void* dx, void* dsb, void* dcp, void* dwd, void* dbd, void* dwo,
    void* dbo, void* z, void* h, void* do_, void* dy, void* wpart,
    void* cpart, void* gsum, int B, int T, int C, int L, int cycle, int rch,
    int cch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sbf = static_cast<const float*>(sb);
  const float* bdf = static_cast<const float*>(bd);
  const float* g = static_cast<const float*>(dout);
  float* f[] = {static_cast<float*>(dx),    static_cast<float*>(dsb),
                static_cast<float*>(dcp),   static_cast<float*>(dwd),
                static_cast<float*>(dbd),   static_cast<float*>(dwo),
                static_cast<float*>(dbo),   static_cast<float*>(z),
                static_cast<float*>(do_),   static_cast<float*>(dy),
                static_cast<float*>(wpart), static_cast<float*>(cpart),
                static_cast<float*>(gsum)};
  if (odt == DSVC_BF16) {
    using bf = __nv_bfloat16;
    return run_bwd<bf, float, float>(
        static_cast<const bf*>(xsave), sbf, static_cast<const bf*>(cond),
        static_cast<const bf*>(wd), bdf, static_cast<const bf*>(wo), g, f[0],
        f[1], f[2], f[3], f[4], f[5], f[6], f[7], static_cast<bf*>(h), f[8],
        f[9], f[10], f[11], f[12], B, T, C, L, cycle, T, rch, cch, s);
  }
  if (odt != DSVC_F32) return static_cast<int>(cudaErrorInvalidValue);
  return run_bwd<float, float, float>(
      static_cast<const float*>(xsave), sbf, static_cast<const float*>(cond),
      static_cast<const float*>(wd), bdf, static_cast<const float*>(wo), g,
      f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], static_cast<float*>(h),
      f[8], f[9], f[10], f[11], f[12], B, T, C, L, cycle, T, rch, cch, s);
}

}  // extern "C"
