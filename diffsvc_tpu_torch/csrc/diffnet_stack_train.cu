// DiffNet residual stack for training (K4) on Hopper: the forward that saves
// each layer's input, and the batch-fused backward over [B, T, C].
//
// Replaces diffsvc_tpu/ops/pallas/diffnet_stack.py:residual_stack_train_batched
// (forward _fwd_kernel via _call_fwd, backward _bwd_kernel_b via
// _call_bwd_batched).  The forward is K1's two kernels per layer
// (diffnet_layer.cuh) with an f32 (or bf16) residual state, operands in the
// stream dtype OT and x_l stored into xsave [L, B, T, C]; K5 (the per-sample
// route) uses the same forward at an f32 stream.  The backward
// (diffnet_train_bwd.cuh, shared with K5) walks the layers in reverse; here
// its weight and bias grads are contracted over all B*T rows as one
// segment, dcp is stored in OT and the cotangent arrives in OT.
// The TPU kernel keeps the [B, T, C] dx carry and the weight-grad
// accumulators in VMEM; here dx lives in device memory (f32) and is handed
// back as dx0 after the last layer (written once, not per layer).
//
// Rounding points follow the TPU kernel: y, h, do, dz rounded to OT before
// the products; z, dx, dz sums and all weight/bias grads f32; dcp stored in
// OT.  What bounds it on the H100: FLOPs on the CUDA cores, 60 C^2 FLOPs
// per row and layer for the forward and backward together (~4.4 TFLOP at
// B=24, T=1024, C=384, L=20).  Tensor-core tiles are later work.
#include "diffnet_train_bwd.cuh"

extern "C" {

// Forward with save.  x [B,T,C] state (xdt, updated in place), h [B,T,C]
// scratch (odt), skip [B,T,C] f32 out, xsave [L,B,T,C] (odt) out; sb
// [L,B,C] f32 with element strides (sb_l, sb_b); cond [L,B,T,2C], wd
// [L,3,C,2C], wo [L,C,2C] in odt; bd, bo [L,2C] f32.
int dsvc_stack_train_fwd(int xdt, int odt, void* x, void* h, void* skip,
                         void* xsave, const void* sb, long long sb_l,
                         long long sb_b, const void* cond, const void* wd,
                         const void* bd, const void* wo, const void* bo,
                         int B, int T, int C, int L, int cycle, void* stream) {
  if (xsave == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const float* sbf = static_cast<const float*>(sb);
  const float* bdf = static_cast<const float*>(bd);
  const float* bof = static_cast<const float*>(bo);
  float* sk = static_cast<float*>(skip);
  if (xdt == DSVC_F32 && odt == DSVC_F32)
    return run_stack<float, float, float>(
        static_cast<float*>(x), static_cast<float*>(h), sk,
        static_cast<float*>(xsave), sbf, sb_l, sb_b,
        static_cast<const float*>(cond), static_cast<const float*>(wd), bdf,
        static_cast<const float*>(wo), bof, B, T, C, L, cycle, s);
  if (xdt == DSVC_F32 && odt == DSVC_BF16)
    return run_stack<float, bf, float>(
        static_cast<float*>(x), static_cast<bf*>(h), sk,
        static_cast<bf*>(xsave), sbf, sb_l, sb_b, static_cast<const bf*>(cond),
        static_cast<const bf*>(wd), bdf, static_cast<const bf*>(wo), bof, B,
        T, C, L, cycle, s);
  if (xdt == DSVC_BF16 && odt == DSVC_BF16)
    return run_stack<bf, bf, float>(
        static_cast<bf*>(x), static_cast<bf*>(h), sk, static_cast<bf*>(xsave),
        sbf, sb_l, sb_b, static_cast<const bf*>(cond),
        static_cast<const bf*>(wd), bdf, static_cast<const bf*>(wo), bof, B,
        T, C, L, cycle, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Batch-fused backward.  In: xsave [L,B,T,C], sb [L,B,C] f32 (contiguous),
// cond [L,B,T,2C], wd, wo, dout [B,T,C] (odt), bd [L,2C] f32.  Out: dx
// [B,T,C] f32 (= dx0), dsb [L,B,C] f32, dcp [L,B,T,2C] odt, dwd [L,3,C,2C],
// dbd [L,2C], dwo [L,C,2C], dbo [L,2C] f32.  Scratch as run_bwd states with
// one segment of B*T rows (no gsum).
int dsvc_stack_train_bwd(int odt, const void* xsave, const void* sb,
                         const void* cond, const void* wd, const void* bd,
                         const void* wo, const void* dout, void* dx, void* dsb,
                         void* dcp, void* dwd, void* dbd, void* dwo, void* dbo,
                         void* z, void* h, void* do_, void* dy, void* wpart,
                         void* cpart, int B, int T, int C, int L, int cycle,
                         int rch, int cch, void* stream) {
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
    return run_bwd<bf, bf, bf>(
        static_cast<const bf*>(xsave), sbf, static_cast<const bf*>(cond),
        static_cast<const bf*>(wd), bdf, static_cast<const bf*>(wo),
        static_cast<const bf*>(dout), f[0], f[1], static_cast<bf*>(dcp), f[2],
        f[3], f[4], f[5], f[6], static_cast<bf*>(h), f[7], f[8], f[9], f[10],
        nullptr, B, T, C, L, cycle, B * T, rch, cch, s);
  }
  if (odt != DSVC_F32) return static_cast<int>(cudaErrorInvalidValue);
  return run_bwd<float, float, float>(
      static_cast<const float*>(xsave), sbf, static_cast<const float*>(cond),
      static_cast<const float*>(wd), bdf, static_cast<const float*>(wo),
      static_cast<const float*>(dout), f[0], f[1], static_cast<float*>(dcp),
      f[2], f[3], f[4], f[5], f[6], static_cast<float*>(h), f[7], f[8], f[9],
      f[10], nullptr, B, T, C, L, cycle, B * T, rch, cch, s);
}

}  // extern "C"
