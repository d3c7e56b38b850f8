// One gated residual layer of DiffNet at f32 on Hopper's tensor cores, as
// 3xTF32 split products (K1's f32 route; K2 runs it once per evaluation,
// the training forward at the f32 stream, diffnet_stack_train.cu, and the
// single block K6, diffnet_block.cu, once).
// Replaces, for f32 operands, diffsvc_tpu/ops/pallas/diffnet_stack.py:
// residual_stack (kernel _kernel).  The TPU kernel has no f32 form: JAX
// refuses f32 there, since single-pass MXU products would make the f32
// path bf16-accurate, and samples f32 through the XLA scan, whose products
// are true f32.  Per layer l, with d = 2^(l mod cycle), all state in f32:
//   y = x + sb_l
//   z = y[t-d] W0 + y[t] W1 + y[t+d] W2 + bd + cond_l   (zeros outside [0,T))
//   h = sigmoid(z[:C]) * tanh(z[C:])
//   o = h wo + bo
//   x <- (x + o[:C]) / sqrt(2);   skip += o[C:]
//
// The arithmetic: every f32 operand is split as a = hi + lo + r, with hi =
// tf32(a) and lo = tf32(a - hi) (cvt.rna; a - hi is exact in f32, so |r| <=
// 2^-22 |a|), and each product is a_lo b_hi + a_hi b_lo + a_hi b_hi on
// wgmma.mma_async m64n64k8 .tf32 with f32 accumulators.  That is good to
// ~2^-21 relative, the order of f32 rounding, where one TF32 product gives
// ~2^-11; the dropped a_lo b_lo is below 2^-22.  Per k8 step the two small
// products go into the accumulator before the large one, the order of
// CUTLASS's 3xTF32; on the H100 the order made no difference the checks
// could see (with the big product first, K1's and K2's errors moved by
// under 1.5%, measured with one accumulator for all K blocks).  What did
// matter is where the sums round: each 32-deep K block sums in a fresh
// wgmma accumulator and is added into the total with f32 adds (add_block,
// below).  The plain PyTorch form of these products is
// ops/hopper/diffnet_stack.py:matmul_tf32x3.
//
// What bounds it on the H100: tensor-core operations.  At T=1024, C=384,
// L=20 one stack is 48.3 GFLOP of f32 products, three TF32 passes each:
// 0.29 ms at 495 TFLOP/s, against ~160 MB of f32 weights and conditioner
// (0.05 ms at 3.35 TB/s).  Each CTA streams four operand tiles per K block
// (hi and lo of A and B: 4x the bf16 route's bytes from L2 for 6x its
// tensor-core work), so the feed has to keep up with the tensor cores.
// What the design does about it:
// - The weights are split and packed once per call by the wrapper (K-major,
//   padded to Cp = C rounded up to 64, paired gate/filter and
//   residual/skip N tiles as in diffnet_layer_tc.cuh), a hi and a lo plane
//   each: [L, 2, 2Cp, 3Cp] and [L, 2, 2Cp, Cp].
// - The activations are split once, by the kernel that writes them: the
//   out kernel (and y0_kernel, or the ladder's input projection, for layer
//   0) writes y_{l+1} = x_{l+1} + sb_{l+1} and the gate kernel writes h as
//   hi and lo planes of [2, B, T, Cp].  The main loop then only streams
//   tiles with cp.async into the layout wgmma reads, with no conversion and
//   no second pass over shared memory per K block; the price is the lo
//   planes' bytes, which stay in L2 (1.5 MB each at B=1, T=1024).
// - BK = 32 f32 = one 128-byte swizzled row, so a tile is 64 x 32 f32 = 8
//   KB and a k8 step advances the descriptors by 32 bytes, as a bf16 k16
//   step does.  A stage is four tiles (32 KB); a 3-stage ring is 97 KB
//   with its alignment, so two CTAs share an SM and the 192 CTAs of a
//   layer launch at B=1, T=1024 (96 at T=512) run in one wave on 132 SMs.
//   Loads run two K blocks ahead; each block's 12 wgmmas are waited for
//   before its stage is refilled.
// - The epilogues are those of the bf16 route, with f32 state and the
//   split written out; each issues its global loads before any math.
// The launch plan (ops/hopper/diffnet_stack.py:tc_plan at f32, the fields
// of tc::P_*) is computed by the wrapper and checked here.
#pragma once

#include "diffnet_layer_tc.cuh"

namespace {
namespace tf32x3 {

using tc::acc_col;
using tc::acc_row;
using tc::align_pad;
using tc::allow_smem;
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::desc;
using tc::fence_acc;
using tc::fence_proxy_async;
using tc::smem_u32;
using tc::swz;
using tc::wgmma_commit;
using tc::wgmma_fence;
using tc::wgmma_wait;
using wg::tf32_rna;

constexpr int BM = 64;          // rows per CTA: one wgmma M
constexpr int BN = 64;          // wgmma N
constexpr int HALF = BN / 2;    // channels per paired N tile (K1)
constexpr int BK = 32;          // K per stage: one 128-byte swizzle row of f32
constexpr int STAGES = 3;
constexpr int THREADS = 128;    // one warpgroup
constexpr int TILE = BM * BK * 4;   // bytes of one 64 x 32 f32 tile
constexpr int STAGE = 4 * TILE;     // A hi, A lo, B hi, B lo
constexpr int ALIGN = 1024;     // the 128-byte swizzle repeats every 1 KB
constexpr int SMEM_MAX = 232448;
constexpr int PREFETCH = STAGES - 1;

constexpr int smem_ring() { return STAGES * STAGE + ALIGN; }

// The plan matches these kernels' compile-time tiles and covers [B, T, C]
// (and M for the ladder's projections, when M > 0).
inline bool plan_ok(const int* p, int T, int C, int M) {
  if (p == nullptr || p[tc::P_BM] != BM || p[tc::P_BN] != BN ||
      p[tc::P_BK] != BK || p[tc::P_STAGES] != STAGES ||
      p[tc::P_THREADS] != THREADS)
    return false;
  const int cp = p[tc::P_CP];
  if (cp % BN != 0 || cp < C || cp - C >= BN) return false;
  if (p[tc::P_GRID_M] != (T + BM - 1) / BM ||
      p[tc::P_GRID_N_LAYER] * HALF != cp)
    return false;
  if (p[tc::P_SMEM_LAYER] < smem_ring() || p[tc::P_SMEM_LAYER] > SMEM_MAX)
    return false;
  if (M <= 0) return true;
  const int mp = p[tc::P_MP];
  return mp % BN == 0 && mp >= M && mp - M < BN &&
         p[tc::P_GRID_N_IN] * BN == cp &&
         p[tc::P_SMEM_IN] >= 4 * (mp / BK) * TILE + ALIGN &&
         p[tc::P_SMEM_IN] <= SMEM_MAX && p[tc::P_SMEM_EPI] >= smem_ring() &&
         p[tc::P_SMEM_EPI] <= SMEM_MAX;
}

// a into the hi and lo planes at element i (lo `plane` elements after hi).
__device__ __forceinline__ void store_split(float* dst, size_t i,
                                            size_t plane, float a) {
  const float hi = tf32_rna(a);
  dst[i] = hi;
  dst[plane + i] = tf32_rna(a - hi);
}

// d[64 x 64] = A[64 x 8] B[64 x 8]^T + (accumulate ? d : 0), TF32
// operands K-major in shared memory (the only layout .tf32 takes, so no
// transpose immediates), f32 accumulators laid out as in
// tc::wgmma_m64n64k16.
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// One 32-deep K block at 3xTF32 into blk, which its first wgmma overwrites:
// per k8 step a_lo b_hi, a_hi b_lo, then a_hi b_hi, the descriptors
// advanced 32 bytes inside the swizzled rows.  The caller adds blk into its
// total once the group has completed (add_block).
__device__ __forceinline__ void mma_block(float (&blk)[32], uint32_t a_hi,
                                          uint32_t a_lo, uint32_t b_hi,
                                          uint32_t b_lo) {
#pragma unroll
  for (int k = 0; k < BK / 8; ++k) {
    const uint32_t o = 32 * k;
    wgmma_m64n64k8(blk, desc(a_lo + o), desc(b_hi + o), k > 0);
    wgmma_m64n64k8(blk, desc(a_hi + o), desc(b_lo + o), 1);
    wgmma_m64n64k8(blk, desc(a_hi + o), desc(b_hi + o), 1);
  }
}

// acc += blk with f32 adds that round to nearest.  The tensor cores' own
// f32 accumulation does not: K1 summed in one wgmma accumulator over all
// its K blocks read 7.7e-6 against the true-f32 plain version on the H100,
// 12x the CUDA-core kernel's error, while the same sums rounded to nearest
// (the plain 3xTF32 emulation) stay at the f32 kernel's level.  A block
// sums 12 products per element in the tensor cores and the blocks add up
// here.
__device__ __forceinline__ void add_block(float (&acc)[32],
                                          const float (&blk)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += blk[i];
}

// One CTA's product: A is rows t0.. of one sample, `a` its hi plane with
// row stride lda and the lo plane a_plane elements on; with taps = 3 the K
// blocks run over the rows t-d, t, t+d of lda channels each (rows outside
// [0, T) zero-filled by cp.async).  B is this N tile's BN rows of a
// K-major [N, taps lda] hi plane `b`, the lo plane b_plane elements on.
struct Operands {
  const float* a;
  size_t a_plane;
  const float* b;
  size_t b_plane;
  int T, t0, lda, taps, d;
};

// This thread's cp.async copies of K block kb into a ring stage: 4 x 4
// 16-byte chunks, one per tile and row quarter.
__device__ __forceinline__ void load_stage(const Operands& op, int kb,
                                           uint32_t st) {
  const int kpt = op.lda / BK;
  const int tap = kb / kpt, c0 = (kb - tap * kpt) * BK;
  const int shift = op.taps == 3 ? (tap - 1) * op.d : 0;
  const size_t ldb = (size_t)op.taps * op.lda;
#pragma unroll
  for (int i = 0; i < BM * 8 / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS, r = e >> 3, ch = e & 7;
    const int ts = op.t0 + r + shift;
    const bool ok = ts >= 0 && ts < op.T;
    const float* src = ok ? op.a + (size_t)ts * op.lda + c0 + ch * 4 : op.a;
    cp_async16(st + swz(r, ch), src, ok);
    cp_async16(st + TILE + swz(r, ch), ok ? src + op.a_plane : op.a, ok);
    const float* w = op.b + r * ldb + kb * BK + ch * 4;
    cp_async16(st + 2 * TILE + swz(r, ch), w, true);
    cp_async16(st + 3 * TILE + swz(r, ch), w + op.b_plane, true);
  }
}

// acc += A B^T over all K blocks through the STAGES-deep ring, filled
// PREFETCH blocks ahead.  The stage a load overwrites was read by the
// previous block's wgmmas, which every thread waited for before the
// barrier that precedes the load.  Every thread waits for its copies,
// fences them for the async proxy and meets the others before the wgmmas.
__device__ __forceinline__ void mainloop(float (&acc)[32], const Operands& op,
                                         uint32_t ring) {
  const int nk = op.taps * op.lda / BK;
  float blk[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) blk[i] = 0.f;
#pragma unroll
  for (int s = 0; s < PREFETCH; ++s) {
    if (s < nk) load_stage(op, s, ring + s * STAGE);
    cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    cp_async_wait<PREFETCH - 1>();
    fence_proxy_async();
    __syncthreads();
    const int nxt = kb + PREFETCH;
    if (nxt < nk) load_stage(op, nxt, ring + (nxt % STAGES) * STAGE);
    cp_async_commit();
    const uint32_t st = ring + (kb % STAGES) * STAGE;
    fence_acc(blk);
    wgmma_fence();
    mma_block(blk, st, st + TILE, st + 2 * TILE, st + 3 * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(blk);
    add_block(acc, blk);
  }
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ uint32_t ring_base(uint8_t* smem_raw) {
  return smem_u32(smem_raw) + align_pad(smem_raw);
}

// Gate: h = sigmoid(z[:C]) * tanh(z[C:]) for rows t0.. of sample b and
// channels n0 = 32 blockIdx.y ..., written as hi and lo planes; K = 3 taps x
// Cp.  y and h are [2, B, T, Cp]; wp is this layer's [2, 2Cp, 3Cp].
__global__ void __launch_bounds__(THREADS)
gate_kernel(const float* __restrict__ y, const float* __restrict__ wp,
            const float* __restrict__ bd, const float* __restrict__ cond,
            float* __restrict__ h, int B, int T, int C, int cp, int d) {
  extern __shared__ uint8_t smem_raw[];
  const int t0 = blockIdx.x * BM, nt = blockIdx.y, b = blockIdx.z;
  const size_t plane = (size_t)B * T * cp;
  const Operands op{y + (size_t)b * T * cp, plane,
                    wp + (size_t)nt * BN * 3 * cp, (size_t)2 * cp * 3 * cp,
                    T, t0, cp, 3, d};
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  mainloop(acc, op, ring_base(smem_raw));

  // the epilogue's loads first, all in flight together, then the math
  const int r0 = acc_row(), cq = acc_col(), n0 = nt * HALF;
  const size_t C2 = 2 * (size_t)C;
  float bg[8], bf[8], cg[16], cf[16];
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + r0 + 8 * (e >> 1), o = n0 + 8 * j + cq + (e & 1);
      const bool ok = t < T && o < C;
      const size_t row = (size_t)b * T + t;
      if (e < 2) {
        bg[2 * j + e] = o < C ? bd[o] : 0.f;
        bf[2 * j + e] = o < C ? bd[C + o] : 0.f;
      }
      cg[4 * j + e] = ok ? cond[row * C2 + o] : 0.f;
      cf[4 * j + e] = ok ? cond[row * C2 + C + o] : 0.f;
    }
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + r0 + 8 * (e >> 1), o = n0 + 8 * j + cq + (e & 1);
      if (t >= T || o >= C) continue;
      const float zg = acc[4 * j + e] + bg[2 * j + (e & 1)] + cg[4 * j + e];
      const float zf = acc[4 * (j + HALF / 8) + e] + bf[2 * j + (e & 1)] +
                       cf[4 * j + e];
      store_split(h, ((size_t)b * T + t) * cp + o, plane,
                  dsvc::sigmoidf_(zg) * tanhf(zf));
    }
}

// Output projection: o = h wo + bo; x <- (x + o[:C]) / sqrt 2 in place,
// skip = o[C:] (first layer) or skip + o[C:], and, unless y is null, y's hi
// and lo planes: the next layer's y = x + sb_next, or (sbn null) the scaled
// skip sum skip * sk_scale that K2's skip projection reads.  h and y are [2,
// B, T, Cp]; wp is this layer's [2, 2Cp, Cp].  Unless xsave is null, the
// layer's input x goes there first (the training forward).
__global__ void __launch_bounds__(THREADS)
out_kernel(const float* __restrict__ h, const float* __restrict__ wp,
           const float* __restrict__ bo, float* __restrict__ x,
           float* __restrict__ skip, float* __restrict__ y,
           const float* __restrict__ sbn, long long sb_b, float sk_scale,
           float* __restrict__ xsave, int B, int T, int C, int cp,
           int first) {
  extern __shared__ uint8_t smem_raw[];
  const int t0 = blockIdx.x * BM, nt = blockIdx.y, b = blockIdx.z;
  const size_t plane = (size_t)B * T * cp;
  const Operands op{h + (size_t)b * T * cp, plane,
                    wp + (size_t)nt * BN * cp, (size_t)2 * cp * cp,
                    T, t0, cp, 1, 0};
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  mainloop(acc, op, ring_base(smem_raw));

  // the epilogue's loads first, all in flight together, then the math
  const float inv_sqrt2 = 0.7071067811865476f;
  const int r0 = acc_row(), cq = acc_col(), n0 = nt * HALF;
  float br[8], bs[8], sbv[8], xv[16], sv[16];
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + r0 + 8 * (e >> 1), o = n0 + 8 * j + cq + (e & 1);
      const bool ok = t < T && o < C;
      const size_t idx = ((size_t)b * T + t) * C + o;
      if (e < 2) {
        br[2 * j + e] = o < C ? bo[o] : 0.f;
        bs[2 * j + e] = o < C ? bo[C + o] : 0.f;
        sbv[2 * j + e] = o < C && sbn != nullptr ? sbn[b * sb_b + o] : 0.f;
      }
      xv[4 * j + e] = ok ? x[idx] : 0.f;
      sv[4 * j + e] = ok && !first ? skip[idx] : 0.f;
    }
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + r0 + 8 * (e >> 1), o = n0 + 8 * j + cq + (e & 1);
      if (t >= T || o >= C) continue;
      const size_t row = (size_t)b * T + t, idx = row * C + o;
      const float res = acc[4 * j + e] + br[2 * j + (e & 1)];
      const float sk = acc[4 * (j + HALF / 8) + e] + bs[2 * j + (e & 1)];
      const float xn = (xv[4 * j + e] + res) * inv_sqrt2;
      const float sn = first ? sk : sv[4 * j + e] + sk;
      if (xsave != nullptr) xsave[idx] = xv[4 * j + e];
      x[idx] = xn;
      skip[idx] = sn;
      if (y != nullptr)
        store_split(y, row * cp + o, plane,
                    sbn != nullptr ? xn + sbv[2 * j + (e & 1)]
                                   : sn * sk_scale);
    }
}

// Layer 0's y = x + sb_0 into the hi and lo planes of y [2, B, T, Cp].
__global__ void y0_kernel(const float* __restrict__ x,
                          const float* __restrict__ sb0, long long sb_b,
                          float* __restrict__ y, int B, int T, int C, int cp) {
  const long long n = (long long)B * T * C;
  const size_t plane = (size_t)B * T * cp;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / C;
    const int c = static_cast<int>(i - row * C);
    const long long b = row / T;
    store_split(y, row * cp + c, plane, x[i] + sb0[b * sb_b + c]);
  }
}

// Both layer kernels may use the plan's shared memory.
inline int prepare_layers(const int* plan) {
  int e = allow_smem(gate_kernel, plan[tc::P_SMEM_LAYER]);
  if (e == 0) e = allow_smem(out_kernel, plan[tc::P_SMEM_LAYER]);
  return e;
}

// The L layers in order: x [B,T,C] f32 state (in place); y and h [2,B,T,Cp]
// hi/lo planes with zero pad channels (y holds layer 0's y already when
// y_ready); skip [B,T,C] f32 out; sb [L,B,C] with element strides (sb_l,
// sb_b); cond [L,B,T,2C]; wdp [L,2,2Cp,3Cp] and wop [L,2,2Cp,Cp] split and
// packed by the wrapper; bd, bo [L,2C].  With sk_scale > 0 the last layer
// writes y = skip * sk_scale (K2's skip projection reads it).  xsave
// (unless null) [L,B,T,C] gets each layer's input.  prepare_layers(plan)
// must have run.
inline int run_stack(float* x, float* y, float* h, float* skip,
                     const float* sb, long long sb_l, long long sb_b,
                     const float* cond, const float* wdp, const float* bd,
                     const float* wop, const float* bo, int B, int T, int C,
                     int L, int cycle, bool y_ready, float sk_scale,
                     const int* plan, cudaStream_t s,
                     float* xsave = nullptr) {
  const int cp = plan[tc::P_CP], smem = plan[tc::P_SMEM_LAYER];
  const dim3 grid(plan[tc::P_GRID_M], plan[tc::P_GRID_N_LAYER], B);
  const long long rows = (long long)B * T, C2 = 2LL * C;
  if (!y_ready) {
    const long long need = (rows * C + 255) / 256;
    const int blocks = static_cast<int>(need < 4096 ? need : 4096);
    y0_kernel<<<blocks, 256, 0, s>>>(x, sb, sb_b, y, B, T, C, cp);
    DSVC_LAUNCH_CHECK();
  }
  for (int l = 0; l < L; ++l) {
    const int d = 1 << (l % cycle);
    gate_kernel<<<grid, THREADS, smem, s>>>(
        y, wdp + (size_t)l * 2 * (2 * cp) * (3 * cp), bd + l * C2,
        cond + l * rows * C2, h, B, T, C, cp, d);
    DSVC_LAUNCH_CHECK();
    const bool last = l + 1 == L;
    out_kernel<<<grid, THREADS, smem, s>>>(
        h, wop + (size_t)l * 2 * (2 * cp) * cp, bo + l * C2, x, skip,
        last && sk_scale <= 0.f ? nullptr : y,
        last ? nullptr : sb + (l + 1) * sb_l, sb_b, sk_scale,
        xsave == nullptr ? nullptr : xsave + l * rows * C, B, T, C, cp,
        l == 0);
    DSVC_LAUNCH_CHECK();
  }
  return 0;
}

}  // namespace tf32x3
}  // namespace
