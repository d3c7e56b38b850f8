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
// H100: tensor-core operations, 44 C^2 FLOPs per row and layer.  The f32
// products run as 3xTF32 split products (diffnet_train_bwd.cuh): each f32
// operand in a hi and a lo TF32 plane, three tensor-core products per f32
// product, good to ~2^-21 relative where one TF32 product gives ~2^-11, so
// the route keeps the f32 accuracy it exists for (26.4 ms of tensor-core
// time per 4.35 TFLOP at 495/3 TFLOP/s, against 65 ms on the CUDA cores).
#include "diffnet_train_bwd.cuh"

extern "C" {

// In: xsave [L,B,T,C], cond [L,B,T,2C] (odt, the state's dtype), sb [L,B,C]
// f32 (contiguous), bd [L,2C] f32, dout [B,T,C] f32; wdg, wdh, wdy the
// weights packed by the wrapper (ttc::run_bwd).  Out: dx [B,T,C] (= dx0),
// dsb [L,B,C], dcp [L,B,T,2C], dwd, dbd, dwo, dbo summed over the batch in
// sample order, all f32.  Scratch as ttc::run_bwd states with segments of
// T rows, gsum [B, 2C] f32; the seven planes zeroed, in odt.
int dsvc_stack_train_bwd_per_sample(
    int odt, const void* xsave, const void* sb, const void* cond,
    const void* wdg, const void* wdh, const void* wdy, const void* bd,
    const void* dout, void* dx, void* dsb, void* dcp, void* dwd, void* dbd,
    void* dwo, void* dbo, void* z, void* do_, void* dy, void* ys, void* yt,
    void* ht, void* dos, void* dot, void* dzs, void* dzt, void* wpart,
    void* cpart, void* gsum, int B, int T, int C, int L, int cycle, int rch,
    int cch, const int* plan, void* stream) {
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
    const ttc::Planes<bf> pl{
        static_cast<bf*>(ys),  static_cast<bf*>(yt),  static_cast<bf*>(ht),
        static_cast<bf*>(dos), static_cast<bf*>(dot), static_cast<bf*>(dzs),
        static_cast<bf*>(dzt)};
    return ttc::run_bwd<ttc::Bf16, float, float>(
        static_cast<const bf*>(xsave), sbf, static_cast<const bf*>(cond),
        static_cast<const bf*>(wdg), static_cast<const bf*>(wdh),
        static_cast<const bf*>(wdy), bdf, g, f[0], f[1], f[2], f[3], f[4],
        f[5], f[6], f[7], f[8], f[9], pl, f[10], f[11], f[12], B, T, C, L,
        cycle, T, rch, cch, plan, s);
  }
  if (odt != DSVC_F32) return static_cast<int>(cudaErrorInvalidValue);
  const ttc::Planes<float> pl{
      static_cast<float*>(ys),  static_cast<float*>(yt),
      static_cast<float*>(ht),  static_cast<float*>(dos),
      static_cast<float*>(dot), static_cast<float*>(dzs),
      static_cast<float*>(dzt)};
  return ttc::run_bwd<ttc::Tf32x3, float, float>(
      static_cast<const float*>(xsave), sbf, static_cast<const float*>(cond),
      static_cast<const float*>(wdg), static_cast<const float*>(wdh),
      static_cast<const float*>(wdy), bdf, g, f[0], f[1], f[2], f[3], f[4],
      f[5], f[6], f[7], f[8], f[9], pl, f[10], f[11], f[12], B, T, C, L, cycle,
      T, rch, cch, plan, s);
}

}  // extern "C"
