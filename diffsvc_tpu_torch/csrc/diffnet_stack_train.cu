// DiffNet residual stack for training (K4) on Hopper: the forward that saves
// each layer's input, and the batch-fused backward over [B, T, C].
//
// Replaces diffsvc_tpu/ops/pallas/diffnet_stack.py:residual_stack_train_batched
// (forward _fwd_kernel via _call_fwd, backward _bwd_kernel_b via
// _call_bwd_batched).  The forward is K1's two tensor-core kernels per
// layer with the residual state in x0's dtype (f32 in training) and the
// operands in the stream dtype: at bf16 diffnet_layer_tc.cuh (f32 state and
// biases as template arguments), at f32 diffnet_layer_tf32x3.cuh (3xTF32);
// the output kernel of layer l stores x_l, rounded to the stream, into
// xsave [L, B, T, C] before it updates x.  K5 (the per-sample route) uses
// the same forward at an f32 stream.  The backward (diffnet_train_bwd.cuh,
// shared with K5) walks the layers in reverse on the same tensor cores;
// here its weight and bias grads are contracted over all B*T rows as one
// segment, dcp is stored in the stream dtype and the cotangent arrives in
// it.  The TPU kernel keeps the [B, T, C] dx carry and the weight-grad
// accumulators in VMEM; here dx lives in device memory (f32) and is handed
// back as dx0 after the last layer (written once, not per layer).
//
// Rounding points follow the TPU kernel: y, h, do, dz rounded to the
// stream before the products; z, dx, dz sums and all weight/bias grads f32;
// dcp stored in the stream dtype.  What bounds it on the H100: tensor-core
// operations, 60 C^2 FLOPs per row and layer for the forward and backward
// together (4.35 TFLOP at B=24, T=1024, C=384, L=20): 4.4 ms at bf16, 26.4
// ms at 3xTF32.
#include "diffnet_train_bwd.cuh"

extern "C" {

// Forward with save.  x [B,T,C] state (xdt, updated in place), y and h the
// layer scratch of K1's route (odt: [B,T,Cp] at bf16, [2,B,T,Cp] hi and lo
// planes at f32, zero pad channels), skip [B,T,C] f32 out, xsave [L,B,T,C]
// (odt) out; sb [L,B,C] f32 with element strides (sb_l, sb_b); cond
// [L,B,T,2C] in odt; wd and wo packed by the wrapper as K1's route reads
// them; bd, bo [L,2C] f32; plan K1's launch plan at odt.
int dsvc_stack_train_fwd(int xdt, int odt, void* x, void* y, void* h,
                         void* skip, void* xsave, const void* sb, long long sb_l,
                         long long sb_b, const void* cond, const void* wd,
                         const void* bd, const void* wo, const void* bo,
                         int B, int T, int C, int L, int cycle,
                         const int* plan, void* stream) {
  if (xsave == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const float* sbf = static_cast<const float*>(sb);
  const float* bdf = static_cast<const float*>(bd);
  const float* bof = static_cast<const float*>(bo);
  float* sk = static_cast<float*>(skip);
  if (odt == DSVC_F32) {
    if (xdt != DSVC_F32 || !tf32x3::plan_ok(plan, T, C, 0))
      return static_cast<int>(cudaErrorInvalidValue);
    const int e = tf32x3::prepare_layers(plan);
    if (e != 0) return e;
    return tf32x3::run_stack(
        static_cast<float*>(x), static_cast<float*>(y), static_cast<float*>(h),
        sk, sbf, sb_l, sb_b, static_cast<const float*>(cond),
        static_cast<const float*>(wd), bdf, static_cast<const float*>(wo), bof,
        B, T, C, L, cycle, false, 0.f, plan, s, static_cast<float*>(xsave));
  }
  if (odt != DSVC_BF16 || !tc::plan_ok(plan, T, C, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf* cb = static_cast<const bf*>(cond);
  const bf* wdb = static_cast<const bf*>(wd);
  const bf* wob = static_cast<const bf*>(wo);
  bf* yb = static_cast<bf*>(y);
  bf* hb = static_cast<bf*>(h);
  bf* xs = static_cast<bf*>(xsave);
  if (xdt == DSVC_F32) {
    const int e = tc::prepare_layers<float, float>(plan);
    if (e != 0) return e;
    return tc::run_stack_tc(static_cast<float*>(x), yb, hb, sk, sbf, sb_l,
                            sb_b, cb, wdb, bdf, wob, bof, B, T, C, L, cycle,
                            false, plan, s, xs);
  }
  if (xdt != DSVC_BF16) return static_cast<int>(cudaErrorInvalidValue);
  const int e = tc::prepare_layers<bf, float>(plan);
  if (e != 0) return e;
  return tc::run_stack_tc(static_cast<bf*>(x), yb, hb, sk, sbf, sb_l, sb_b, cb,
                          wdb, bdf, wob, bof, B, T, C, L, cycle, false, plan,
                          s, xs);
}

// Batch-fused backward.  In: xsave [L,B,T,C], cond [L,B,T,2C], dout [B,T,C]
// (odt); sb [L,B,C] f32 (contiguous), bd [L,2C] f32; wdg, wdh, wdy the
// weights packed by the wrapper (ttc::run_bwd).  Out: dx [B,T,C] f32 (=
// dx0), dsb [L,B,C] f32, dcp [L,B,T,2C] odt, dwd [L,3,C,2C], dbd [L,2C],
// dwo [L,C,2C], dbo [L,2C] f32.  Scratch as ttc::run_bwd states with one
// segment of B*T rows (no gsum); the seven planes zeroed, in odt.
int dsvc_stack_train_bwd(int odt, const void* xsave, const void* sb,
                         const void* cond, const void* wdg, const void* wdh,
                         const void* wdy, const void* bd, const void* dout,
                         void* dx, void* dsb, void* dcp, void* dwd, void* dbd,
                         void* dwo, void* dbo, void* z, void* do_, void* dy,
                         void* ys, void* yt, void* ht, void* dos, void* dot,
                         void* dzs, void* dzt, void* wpart, void* cpart, int B,
                         int T, int C, int L, int cycle, int rch, int cch,
                         const int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sbf = static_cast<const float*>(sb);
  const float* bdf = static_cast<const float*>(bd);
  float* f[] = {static_cast<float*>(dx),    static_cast<float*>(dsb),
                static_cast<float*>(dwd),   static_cast<float*>(dbd),
                static_cast<float*>(dwo),   static_cast<float*>(dbo),
                static_cast<float*>(z),     static_cast<float*>(do_),
                static_cast<float*>(dy),    static_cast<float*>(wpart),
                static_cast<float*>(cpart)};
  if (odt == DSVC_BF16) {
    using bf = __nv_bfloat16;
    const ttc::Planes<bf> pl{
        static_cast<bf*>(ys),  static_cast<bf*>(yt),  static_cast<bf*>(ht),
        static_cast<bf*>(dos), static_cast<bf*>(dot), static_cast<bf*>(dzs),
        static_cast<bf*>(dzt)};
    return ttc::run_bwd<ttc::Bf16, bf, bf>(
        static_cast<const bf*>(xsave), sbf, static_cast<const bf*>(cond),
        static_cast<const bf*>(wdg), static_cast<const bf*>(wdh),
        static_cast<const bf*>(wdy), bdf, static_cast<const bf*>(dout), f[0],
        f[1], static_cast<bf*>(dcp), f[2], f[3], f[4], f[5], f[6], f[7], f[8],
        pl, f[9], f[10], nullptr, B, T, C, L, cycle, B * T, rch, cch, plan, s);
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
      static_cast<const float*>(wdy), bdf, static_cast<const float*>(dout),
      f[0], f[1], static_cast<float*>(dcp), f[2], f[3], f[4], f[5], f[6], f[7],
      f[8], pl, f[9], f[10], nullptr, B, T, C, L, cycle, B * T, rch, cch, plan,
      s);
}

}  // extern "C"
