// One gated residual block of DiffNet (K6) on Hopper's tensor cores.
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
// What bounds it on the H100: tensor-core operations, 16 C^2 FLOPs per row
// (~2.4 GFLOP at T=1024, C=384: 2.4 us at bf16, 14.6 us at 3xTF32) against
// 6.3 MB (bf16) or 12.6 MB (f32) of operands and outputs.  At these sizes
// each launch is latency-bound (diffnet_layer_tc.cuh), and calls back to
// back are bound by the host's issue of them.  The design is one layer of
// K1's routes, in three launches: y0 (y = x + step, staged once), the gate
// kernel over the three shifted taps, and the output projection.
// - bf16: K1's y0_kernel and gate_tc_kernel as they are (bf16 operands, f32
//   sums, h rounded to bf16), and an output kernel of its own
//   (block_out_tc_kernel, below) on K1's main loop, whose epilogue rounds
//   at the TPU kernel's points and writes skip in bf16.
// - f32: K1's 3xTF32 layer as it is (every rnd is the identity): y0_kernel
//   with the step as the bias, gate_kernel, and out_kernel on a copy of x
//   (it updates x in place; first = 1 writes skip = o[C:]).
// The weights come packed as K1's (ops/hopper/diffnet_stack.py:pack_layers
// with L = 1); the wrapper keeps them per weight tensor and version.  The
// launch plan is K1's (diffnet_stack.py:tc_plan), checked here.
#include "diffnet_layer_tf32x3.cuh"

namespace {
namespace k6 {

using tc::bf16;
using tc::BM;
using tc::BN;
using tc::BK;
using tc::HALF;
using tc::THREADS;
using dsvc::to_f;

// K6's output projection at bf16: o = h wo + bo; x_out = bf16(bf16(x +
// bf16(o[:C])) * bf16(1/sqrt 2)) and skip = bf16(o[C:]), for rows t0.. of
// sample b and channels n0 = 32 blockIdx.y ...  h [B, T, Cp] with zero pad
// channels; wp [2Cp, Cp] packed as K1's.
__global__ void __launch_bounds__(THREADS)
block_out_tc_kernel(const bf16* __restrict__ h, const bf16* __restrict__ wp,
                    const bf16* __restrict__ bo, const bf16* __restrict__ x,
                    bf16* __restrict__ x_out, bf16* __restrict__ skip, int T,
                    int C, int cp) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = tc::smem_u32(smem_raw) + tc::align_pad(smem_raw);
  const int t0 = blockIdx.x * BM, nt = blockIdx.y, b = blockIdx.z;
  const bf16* hb = h + (size_t)b * T * cp;
  const bf16* wt = wp + (size_t)nt * BN * cp;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  tc::mainloop<true>(
      acc, cp / BK, ring,
      [&](int kb, uint32_t st) {
        tc::load_out_stage(hb, wt, T, t0, cp, kb, st);
      },
      [](int) { return 0u; });

  // the epilogue's loads first, all in flight together, then the math
  const float inv_sqrt2 = to_f(__float2bfloat16(0.7071067811865476f));
  const int r0 = tc::acc_row(), cq = tc::acc_col(), n0 = nt * HALF;
  float br[8], bs[8], xv[16];
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + r0 + 8 * (e >> 1), o = n0 + 8 * j + cq + (e & 1);
      if (e < 2) {
        br[2 * j + e] = o < C ? to_f(bo[o]) : 0.f;
        bs[2 * j + e] = o < C ? to_f(bo[C + o]) : 0.f;
      }
      xv[4 * j + e] =
          t < T && o < C ? to_f(x[((size_t)b * T + t) * C + o]) : 0.f;
    }
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + r0 + 8 * (e >> 1), o = n0 + 8 * j + cq + (e & 1);
      if (t >= T || o >= C) continue;
      const size_t idx = ((size_t)b * T + t) * C + o;
      const float res = dsvc::rnd<bf16>(acc[4 * j + e] + br[2 * j + (e & 1)]);
      const float sum = dsvc::rnd<bf16>(xv[4 * j + e] + res);
      x_out[idx] = __float2bfloat16(sum * inv_sqrt2);
      skip[idx] = __float2bfloat16(acc[4 * (j + HALF / 8) + e] +
                                   bs[2 * j + (e & 1)]);
    }
}

}  // namespace k6
}  // namespace

extern "C" {

// x, step, cond, wd, bd, wo, bo as above in x's dtype, except wd and wo
// packed by the wrapper as K1's with L = 1: [2Cp, 3Cp] and [2Cp, Cp] at
// bf16, hi and lo planes [2, 2Cp, 3Cp] and [2, 2Cp, Cp] at f32.  y and h
// are scratch with zero pad channels: [B, T, Cp] at bf16, [2, B, T, Cp] at
// f32; x_out and skip [B, T, C] outputs; plan K1's launch plan (tc::P_*).
int dsvc_residual_block(int dtype, const void* x, const void* step,
                        const void* cond, const void* wd, const void* bd,
                        const void* wo, const void* bo, void* y, void* h,
                        void* x_out, void* skip, int B, int T, int C, int d,
                        const int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long need = ((long long)B * T * C + 255) / 256;
  const int blocks = static_cast<int>(need < 4096 ? need : 4096);
  if (dtype == DSVC_BF16) {
    using T_ = __nv_bfloat16;
    if (!tc::plan_ok(plan, T, C, 0)) return cudaErrorInvalidValue;
    const int cp = plan[tc::P_CP], smem = plan[tc::P_SMEM_LAYER];
    const dim3 grid(plan[tc::P_GRID_M], plan[tc::P_GRID_N_LAYER], B);
    int e = tc::allow_smem(tc::gate_tc_kernel<T_>, smem);
    if (e == 0) e = tc::allow_smem(k6::block_out_tc_kernel, smem);
    if (e != 0) return e;
    tc::y0_kernel<T_, T_><<<blocks, 256, 0, s>>>(
        static_cast<const T_*>(x), static_cast<const T_*>(step), C,
        static_cast<T_*>(y), B, T, C, cp);
    DSVC_LAUNCH_CHECK();
    tc::gate_tc_kernel<T_><<<grid, tc::THREADS, smem, s>>>(
        static_cast<const T_*>(y), static_cast<const T_*>(wd),
        static_cast<const T_*>(bd), static_cast<const T_*>(cond),
        static_cast<T_*>(h), T, C, cp, d);
    DSVC_LAUNCH_CHECK();
    k6::block_out_tc_kernel<<<grid, tc::THREADS, smem, s>>>(
        static_cast<const T_*>(h), static_cast<const T_*>(wo),
        static_cast<const T_*>(bo), static_cast<const T_*>(x),
        static_cast<T_*>(x_out), static_cast<T_*>(skip), T, C, cp);
    DSVC_LAUNCH_CHECK();
    return 0;
  }
  if (dtype != DSVC_F32) return static_cast<int>(cudaErrorInvalidValue);
  if (!tf32x3::plan_ok(plan, T, C, 0)) return cudaErrorInvalidValue;
  const int e = tf32x3::prepare_layers(plan);
  if (e != 0) return e;
  const int cp = plan[tc::P_CP], smem = plan[tc::P_SMEM_LAYER];
  const dim3 grid(plan[tc::P_GRID_M], plan[tc::P_GRID_N_LAYER], B);
  const float* xf = static_cast<const float*>(x);
  float* xo = static_cast<float*>(x_out);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h);
  const cudaError_t ce = cudaMemcpyAsync(
      xo, xf, sizeof(float) * B * T * C, cudaMemcpyDeviceToDevice, s);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  tf32x3::y0_kernel<<<blocks, 256, 0, s>>>(
      xf, static_cast<const float*>(step), C, yf, B, T, C, cp);
  DSVC_LAUNCH_CHECK();
  tf32x3::gate_kernel<<<grid, tf32x3::THREADS, smem, s>>>(
      yf, static_cast<const float*>(wd), static_cast<const float*>(bd),
      static_cast<const float*>(cond), hf, B, T, C, cp, d);
  DSVC_LAUNCH_CHECK();
  tf32x3::out_kernel<<<grid, tf32x3::THREADS, smem, s>>>(
      hf, static_cast<const float*>(wo), static_cast<const float*>(bo), xo,
      static_cast<float*>(skip), nullptr, nullptr, 0, 0.f, nullptr, B, T, C,
      cp, 1);
  DSVC_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
