// The DiffNet residual stack's training backward on Hopper's tensor cores,
// shared by the batch-fused backward (K4, diffnet_stack_train.cu) and the
// per-sample backward (K5, diffnet_stack_per_sample.cu).  The layers run in
// reverse; per layer l, with d = 2^(l mod cycle):
//   1. stage_y_kernel: y = rnd(x_l + sb_l) from the saved, rounded x_l, as
//      product operands: rows [B*T, Cp] (the gate's A) and, transposed,
//      the three taps y[t-d], y[t], y[t+d] as [3Cp, positions] (dW_j's A);
//   2. regate_tc_kernel: z = conv(y) + bd + cond (K1's gate product; f32 z
//      into scratch) and h = rnd(sigmoid(z_g) tanh(z_f)), transposed (dWo's
//      A);
//   3. make_do_kernel: do = [dx / sqrt2 | dout] in f32 (dbo's column sum)
//      and as operands: rows [B*T, 2Cp] (dh's A) and transposed (dWo's B);
//   4. dh_tc_kernel: dh = rnd(do) wo^T (K = 2C); dz = [dh s(1-s)tf |
//      dh s(1-tf^2)] (f32, in place of z unless dcp holds it), dcp_l = dz
//      in DT; stage_dz_kernel: rnd(dz) as operands, rows (dy's A) and
//      transposed (dW_j's B);
//   5. dy_tc_kernel: dy = sum_j shiftback_j(rnd(dz)) W_j^T (K = 6C, the
//      taps at rows t+d, t, t-d, zero outside the sample);
//      dx <- dy + dx / sqrt2;
//   6. wgrad_tc_kernel: dWo = h^T rnd(do) and dW_j = y_shift(j)^T rnd(dz)
//      (K = rows): the rows are cut into segments (K4: one segment of all
//      B*T rows; K5: one segment per sample), each segment into chunks of
//      at most rch rows that start at the segment's first row; each
//      chunk's CTAs write their own partial, then one kernel sums, for
//      every element, the chunks of each segment in order and the
//      segments' sums in order;
//   7. dbo = sum do, dbd = sum dz (per segment, then over the segments in
//      order), dsb[b] = sum_t dy[b]: two-pass column sums.
// No atomics anywhere: every output element is written by one thread, and
// every reduction sums in a fixed order, so two runs give the same bits, and
// K5 at batch B gives exactly the in-order sum of its B = 1 runs (a chunk's
// product runs the same K blocks in the same order whatever B is).
//
// Types: the operand mode M (below) fixes E, the stream's dtype (xsave,
// cond and the packed weights); DT is the dtype dcp is stored in (K4: E;
// K5: f32, unrounded), GT the skip cotangent's dtype (K4: E; K5: f32).
//
// What bounds it on the H100: tensor-core operations.  The five products
// are 44 C^2 FLOPs per row and layer (with the forward's 16, 60 C^2: 4.35
// TFLOP at B=24, T=1024, C=384, L=20), 4.4 ms at bf16 and 26.4 ms at
// 3xTF32 (495/3 TFLOP/s), against ~2 GB of operands per step.  What the
// design does about it:
// - Every product is a wgmma tile per CTA, both operands K-major in
//   128-byte swizzled shared memory, fed by a cp.async ring: the main loop
//   of K1 (diffnet_layer_tc.cuh, diffnet_layer_tf32x3.cuh), written once
//   here over the operand mode M and the tile (64 x 64 on one warpgroup for
//   the row-tiled products, 128 x 128 on two for the weight grads, whose K
//   runs to 2048 rows): Bf16 (bf16 operands,
//   m64n64k16, f32 accumulators: exactly the bf16 stream's semantics) or
//   Tf32x3 (every f32 operand in a hi and a lo TF32 plane; per k8 step
//   a_lo b_hi + a_hi b_lo + a_hi b_hi, each 32-deep K block in a fresh
//   accumulator added with f32 adds, as K1's f32 route).
// - tf32 wgmma reads both shared-memory operands K-major only, and the
//   weight grads contract over rows, so h, do, dz and y's taps are also
//   written transposed, by the kernel that makes them, as operand planes
//   [channels, positions].  Row r of the batch sits at position chunk * kc
//   + (r - chunk start): each chunk padded to kc, a whole number of K
//   blocks (zeros past its end), so no wgmma sits under a branch (ptxas
//   would serialize them all) and rows past a chunk's end add zero.  The
//   taps of y are three shifted copies (a shift of d = 1, 2, 4 rows cannot
//   move a 16-byte copy), zero where t +- d leaves the sample.
// - The operand forms are written by small transposing kernels (32 x 32
//   tiles through shared memory, coalesced both ways), except h's, which
//   the recompute's epilogue writes: from accumulator fragments, scattered
//   stores cost more than the product whose result they hold (on the
//   H100, dh's epilogue writing dz's four operand planes took 1.0 ms a
//   layer at B=24, T=1024, against 0.2 ms for make_do's transposing pass
//   over as many bytes).
// - The row-major operands (y, do, dz) carry their taps as row offsets of
//   the A tile, each loaded from global memory at its own row (zero-filled
//   outside [0, T) of the sample), as K1's gate kernel does.
// - The transposed weights are packed once per call by the wrapper
//   (ops/hopper/diffnet_stack_train.py:pack_bwd): wo as [Cp, 2Cp] (dh's B),
//   wd's taps as [Cp, 6Cp] (dy's B), and K1's gate packing for the
//   recompute, each with hi and lo planes at f32.
// - The operand planes are scratch for one layer, reused by the next
//   (~3 GB at 88 x 768 in f32); the wrapper zeroes them once per call, so
//   pad channels and pad positions stay zero.
// The launch plan (ops/hopper/diffnet_stack_train.py:train_plan, the
// fields Q_*) is computed by the wrapper and checked here.
#pragma once

#include <type_traits>

#include "diffnet_layer_tf32x3.cuh"

namespace {
namespace ttc {

using bf16 = __nv_bfloat16;
using dsvc::from_f;
using dsvc::rnd;
using dsvc::to_f;
using wg::ALIGN;
using wg::align_pad;
using wg::allow_smem;
using wg::cp_async16;
using wg::cp_async_commit;
using wg::cp_async_wait;
using wg::desc;
using wg::fence_acc;
using wg::fence_proxy_async;
using wg::smem_u32;
using wg::swz;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_wait;

constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr int BM = 64;          // A rows per CTA: one wgmma M
constexpr int BN = 64;          // B rows per CTA: one wgmma N
constexpr int HALF = BN / 2;    // channels per paired N tile (the recompute)
constexpr int THREADS = 128;    // one warpgroup
constexpr int TILE = BM * 128;  // bytes of one operand tile: 64 rows x 128 B
constexpr int KC_ALIGN = 64;    // chunks padded to whole K blocks of both modes
constexpr int SMEM_MAX = 232448;
constexpr int WG_WGS = 2;       // the weight grads' CTA: two warpgroups,
constexpr int WG_NB = 128;      // 128 rows of A and 128 of B
constexpr int TT = 32;          // the transposing kernels' 32 x 32 tiles
constexpr int TT_ROWS = 8;      // ... run by 32 x 8 threads

// The operand modes.  P planes per operand, BK elements (128 bytes) per K
// block, EPC elements per 16-byte copy, a STAGES-deep ring filled
// PREFETCH blocks ahead.
struct Bf16 {
  using E = bf16;
  static constexpr int P = 1, BK = 64, EPC = 8, STAGES = 4, PREFETCH = 2;
  static constexpr bool X3 = false;
  static constexpr int DTYPE = DSVC_BF16;
};
struct Tf32x3 {
  using E = float;
  static constexpr int P = 2, BK = 32, EPC = 4, STAGES = 3, PREFETCH = 2;
  static constexpr bool X3 = true;
  static constexpr int DTYPE = DSVC_F32;
};

// The wrapper's plan, in this order (ops/hopper/diffnet_stack_train.py
// TRAIN_PLAN_FIELDS).
enum {
  Q_MODE, Q_CP, Q_BK, Q_STAGES, Q_THREADS, Q_SMEM, Q_SMEM_W, Q_KC, Q_RP,
  Q_NCHUNK, Q_CPS, Q_GRID_T, Q_GRID_R, Q_GRID_C, Q_GRID_PAIR, Q_GRID_WO,
  Q_GRID_WD, Q_GRID_WN
};

// The shapes every kernel of one backward call shares.
struct Geo {
  int B, T, C, cp;       // batch, frames, channels, channels padded to 64
  long long R;           // rows B*T
  int seg_rows, cps, rch, kc;   // weight-grad segments and chunks
  long long rp;          // positions of the transposed planes: chunks * kc
};

// The position of row r in the transposed planes: its chunk's first
// position plus its offset in the chunk.
__device__ __forceinline__ long long pos_of(long long r, const Geo& g) {
  const long long seg = r / g.seg_rows;
  const int in = static_cast<int>(r - seg * g.seg_rows), k = in / g.rch;
  return (seg * g.cps + k) * g.kc + (in - k * g.rch);
}

// v as a product operand at element i of planes `plane` elements apart:
// rounded to bf16, or split into its TF32 hi and lo planes.
template <class M>
__device__ __forceinline__ void store_op(typename M::E* dst, size_t i,
                                         size_t plane, float v) {
  if constexpr (M::X3)
    tf32x3::store_split(dst, i, plane, v);
  else
    dst[i] = __float2bfloat16(v);
}

// d[64 x 128] = A[64 x K] B[128 x K]^T + (scale_d ? d : 0), both K-major
// in shared memory (bf16: K = 16; TF32: K = 8), f32 accumulators laid out
// as in tc::wgmma_m64n64k16 with j up to 15.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One CTA's product D[WGS 64 x NB] = A B^T over nk K blocks, both operands
// K-major with M::P planes; warpgroup w computes rows 64 w .. 64 w + 63.
// A: rows m0 + r of a row-major [a_rows, lda] matrix (plane a_plane
// elements on); its K blocks run over `taps` taps of ktap elements, tap j
// reading rows m0 + r + (j - 1) shift (zero outside [0, a_rows)).  B: the
// CTA's NB rows of a [b_rows, ldb] matrix from b on (plane b_plane on; rows
// past b_rows zero), K contiguous.
template <typename E>
struct Gemm {
  const E* a;
  size_t a_plane;
  long long lda;
  long long a_rows, m0;
  int taps, ktap, shift;
  const E* b;
  size_t b_plane;
  long long ldb;
  int b_rows;
  int nk;
};

// A ring stage: each warpgroup's A tile (M::P planes of 64 rows), then B's
// planes of NB rows, rows of 128 bytes in the 128-byte swizzle.
template <class M, int WGS, int NB>
__host__ __device__ constexpr int stage_bytes_of() {
  return M::P * (WGS * TILE + NB * 128);
}
template <class M, int WGS, int NB>
__host__ __device__ constexpr int smem_of() {
  return M::STAGES * stage_bytes_of<M, WGS, NB>() + ALIGN;
}

// This thread's cp.async copies of K block kb into a ring stage.
template <class M, int WGS, int NB>
__device__ __forceinline__ void load_stage(const Gemm<typename M::E>& g,
                                           int kb, uint32_t st) {
  constexpr int NT = WGS * THREADS;
  const int kpt = g.ktap / M::BK;
  const int tap = kb / kpt, k0 = (kb - tap * kpt) * M::BK;
  const long long sh = (long long)(tap - 1) * g.shift;
#pragma unroll
  for (int i = 0; i < WGS * BM * 8 / NT; ++i) {
    const int e = threadIdx.x + i * NT, r = e >> 3, ch = e & 7;
    const int w = r / BM, rr = r - w * BM;
    const long long row = g.m0 + r + sh;
    const bool ok = row >= 0 && row < g.a_rows;
    const auto* src = ok ? g.a + row * g.lda + k0 + ch * M::EPC : g.a;
#pragma unroll
    for (int p = 0; p < M::P; ++p)
      cp_async16(st + (w * M::P + p) * TILE + swz(rr, ch),
                 ok ? src + p * g.a_plane : g.a, ok);
  }
  const uint32_t sb = st + WGS * M::P * TILE;
#pragma unroll
  for (int i = 0; i < NB * 8 / NT; ++i) {
    const int e = threadIdx.x + i * NT, n = e >> 3, ch = e & 7;
    const bool ok = n < g.b_rows;
    const auto* w =
        ok ? g.b + n * g.ldb + (long long)kb * M::BK + ch * M::EPC : g.b;
#pragma unroll
    for (int p = 0; p < M::P; ++p)
      cp_async16(sb + p * NB * 128 + swz(n, ch), ok ? w + p * g.b_plane : g.b,
                 ok);
  }
}

// One K block of this warpgroup's product into d: Bf16 accumulates; Tf32x3
// overwrites d (a fresh accumulator) with a_lo b_hi + a_hi b_lo + a_hi b_hi
// per k8 step.
template <class M, int NB>
__device__ __forceinline__ void mma_block(float (&d)[NB / 2], uint32_t a,
                                          uint32_t b) {
  if constexpr (NB == 64) {
    if constexpr (M::X3)
      tf32x3::mma_block(d, a, a + TILE, b, b + NB * 128);
    else
      tc::mma_block(d, a, b);
  } else if constexpr (M::X3) {
#pragma unroll
    for (int k = 0; k < M::BK / 8; ++k) {
      const uint32_t o = 32 * k;
      wgmma_m64n128k8(d, desc(a + TILE + o), desc(b + o), k > 0);
      wgmma_m64n128k8(d, desc(a + o), desc(b + NB * 128 + o), 1);
      wgmma_m64n128k8(d, desc(a + o), desc(b + o), 1);
    }
  } else {
#pragma unroll
    for (int k = 0; k < M::BK / 16; ++k)
      wgmma_m64n128k16(d, desc(a + 32 * k), desc(b + 32 * k), 1);
  }
}

// acc = A B^T through the ring, each warpgroup its own rows.  Bf16: K1's
// bf16 loop (four stages, one wgmma group left in flight); Tf32x3: K1's
// f32 loop (three stages, each block's 12 wgmmas in a fresh accumulator,
// waited for and added into acc).  Either way the stage a load overwrites
// was last read by a wgmma group that every thread has waited for before
// the barrier that precedes the load.
template <class M, int WGS = 1, int NB = BN>
__device__ __forceinline__ void mainloop(float (&acc)[NB / 2],
                                         const Gemm<typename M::E>& g,
                                         uint32_t ring) {
  constexpr uint32_t STAGE = stage_bytes_of<M, WGS, NB>();
  const uint32_t a_off = (threadIdx.x / THREADS) * M::P * TILE;
  const uint32_t b_off = WGS * M::P * TILE;
  float blk[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = blk[i] = 0.f;
#pragma unroll
  for (int s = 0; s < M::PREFETCH; ++s) {
    if (s < g.nk) load_stage<M, WGS, NB>(g, s, ring + s * STAGE);
    cp_async_commit();
  }
  for (int kb = 0; kb < g.nk; ++kb) {
    cp_async_wait<M::PREFETCH - 1>();
    fence_proxy_async();
    __syncthreads();
    const int nxt = kb + M::PREFETCH;
    if (nxt < g.nk)
      load_stage<M, WGS, NB>(g, nxt, ring + (nxt % M::STAGES) * STAGE);
    cp_async_commit();
    const uint32_t st = ring + (kb % M::STAGES) * STAGE;
    if constexpr (M::X3) {
      fence_acc(blk);
      wgmma_fence();
      mma_block<M, NB>(blk, st + a_off, st + b_off);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(blk);
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) acc[i] += blk[i];
    } else {
      fence_acc(acc);
      wgmma_fence();
      mma_block<M, NB>(acc, st + a_off, st + b_off);
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();
  __syncthreads();
}

// The plan matches mode M's tiles and covers [B, T, C] with weight-grad
// segments of seg_rows rows cut into chunks of at most rch.
template <class M>
inline bool plan_ok(const int* p, const Geo& g) {
  if (p == nullptr || p[Q_MODE] != M::DTYPE || p[Q_BK] != M::BK ||
      p[Q_STAGES] != M::STAGES || p[Q_THREADS] != THREADS)
    return false;
  if (p[Q_SMEM] < smem_of<M, 1, BN>() || p[Q_SMEM] > SMEM_MAX ||
      p[Q_SMEM_W] < smem_of<M, WG_WGS, WG_NB>() || p[Q_SMEM_W] > SMEM_MAX)
    return false;
  const int cp = p[Q_CP];
  if (cp != g.cp || cp % BN != 0 || cp < g.C || cp - g.C >= BN) return false;
  if (g.seg_rows <= 0 || g.R % g.seg_rows != 0 || g.rch <= 0) return false;
  const long long nseg = g.R / g.seg_rows;
  const int span = g.seg_rows < g.rch ? g.seg_rows : g.rch;
  if (g.cps != (g.seg_rows + g.rch - 1) / g.rch || p[Q_CPS] != g.cps ||
      g.kc != (span + KC_ALIGN - 1) / KC_ALIGN * KC_ALIGN || p[Q_KC] != g.kc ||
      p[Q_NCHUNK] != nseg * g.cps || p[Q_RP] != (long long)p[Q_NCHUNK] * g.kc ||
      g.rp != p[Q_RP])
    return false;
  constexpr int WM = WG_WGS * BM;
  return p[Q_GRID_T] == (g.T + BM - 1) / BM &&
         p[Q_GRID_R] == (g.R + BM - 1) / BM && p[Q_GRID_C] * BN == cp &&
         p[Q_GRID_PAIR] * HALF == cp && p[Q_GRID_WO] == (cp + WM - 1) / WM &&
         p[Q_GRID_WD] == (3 * cp + WM - 1) / WM &&
         p[Q_GRID_WN] == (2 * cp + WG_NB - 1) / WG_NB;
}

__device__ __forceinline__ uint32_t ring_base(uint8_t* smem_raw) {
  return smem_u32(smem_raw) + align_pad(smem_raw);
}

// ---------------------------------------------------------------------------
// The operands' producers (32 x 32 tiles through shared memory, so both the
// row-major and the transposed writes are coalesced)
// ---------------------------------------------------------------------------

// y = rnd(x_l + sb_l) for rows r0.. and channels c0..: ys [P, R, Cp] and yt
// [P, 3Cp, rp], row j Cp + c of yt holding tap j, y[t + (j - 1) d] (zero
// outside the sample).  xs is this layer's [R, C], sb its [B, C].
template <class M>
__global__ void __launch_bounds__(TT * TT_ROWS)
stage_y_kernel(const typename M::E* __restrict__ xs,
               const float* __restrict__ sb, typename M::E* __restrict__ ys,
               typename M::E* __restrict__ yt, Geo g, int d) {
  using E = typename M::E;
  __shared__ float tile[3][TT][TT + 1];
  const long long r0 = (long long)blockIdx.x * TT;
  const int c0 = blockIdx.y * TT, tx = threadIdx.x;
  for (int i = threadIdx.y; i < TT; i += TT_ROWS) {
    const long long r = r0 + i;
    const int c = c0 + tx;
    float v[3] = {0.f, 0.f, 0.f};
    if (r < g.R && c < g.C) {
      const long long b = r / g.T;
      const int t = static_cast<int>(r - b * g.T);
      const float s = sb[b * g.C + c];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int ts = t + (j - 1) * d;
        if (ts >= 0 && ts < g.T)
          v[j] = rnd<E>(to_f(xs[(b * g.T + ts) * g.C + c]) + s);
      }
      store_op<M>(ys, r * g.cp + c, (size_t)g.R * g.cp, v[1]);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) tile[j][i][tx] = v[j];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < TT; i += TT_ROWS) {
    const int c = c0 + i;
    const long long r = r0 + tx;
    if (r >= g.R || c >= g.C) continue;
    const long long p = pos_of(r, g);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      store_op<M>(yt, (size_t)(j * g.cp + c) * g.rp + p,
                  (size_t)3 * g.cp * g.rp, tile[j][tx][i]);
  }
}

// Rows r0.. and padded columns q0.. (q = h Cp + k is column h C + k) of an
// [R, 2C] f32 matrix, value(r, h C + k), as operands: rows [P, R, 2Cp] and,
// transposed, [P, 2Cp, rp].
template <class M, class Value>
__device__ __forceinline__ void stage_2c(Value value,
                                         typename M::E* __restrict__ rows,
                                         typename M::E* __restrict__ tr,
                                         const Geo& g) {
  __shared__ float tile[TT][TT + 1];
  const long long r0 = (long long)blockIdx.x * TT;
  const int q0 = blockIdx.y * TT, tx = threadIdx.x;
  const int h = q0 / g.cp;
  for (int i = threadIdx.y; i < TT; i += TT_ROWS) {
    const long long r = r0 + i;
    const int k = q0 - h * g.cp + tx;
    float v = 0.f;
    if (r < g.R && k < g.C) {
      v = value(r, h * g.C + k);
      store_op<M>(rows, r * 2 * g.cp + q0 + tx, (size_t)g.R * 2 * g.cp, v);
    }
    tile[i][tx] = v;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < TT; i += TT_ROWS) {
    const int q = q0 + i;
    const long long r = r0 + tx;
    if (r >= g.R || q - h * g.cp >= g.C) continue;
    store_op<M>(tr, (size_t)q * g.rp + pos_of(r, g), (size_t)2 * g.cp * g.rp,
                tile[tx][i]);
  }
}

// do = [dx / sqrt2 | dout]: do_ [R, 2C] f32, dos [P, R, 2Cp] and dot [P,
// 2Cp, rp] as operands (stage_2c's tiles).
template <class M, typename GT>
__global__ void __launch_bounds__(TT * TT_ROWS)
make_do_kernel(const float* __restrict__ dx, const GT* __restrict__ dout,
               float* __restrict__ do_, typename M::E* __restrict__ dos,
               typename M::E* __restrict__ dot, Geo g) {
  stage_2c<M>(
      [&](long long r, int col) {
        const float v = col < g.C ? dx[r * g.C + col] * kInvSqrt2
                                  : to_f(dout[r * g.C + col - g.C]);
        do_[r * 2 * g.C + col] = v;
        return v;
      },
      dos, dot, g);
}

// dz [R, 2C] f32 as operands: dzs [P, R, 2Cp] (dy's A) and dzt [P, 2Cp, rp]
// (dW_j's B), stage_2c's tiles.
template <class M>
__global__ void __launch_bounds__(TT * TT_ROWS)
stage_dz_kernel(const float* __restrict__ dz, typename M::E* __restrict__ dzs,
                typename M::E* __restrict__ dzt, Geo g) {
  stage_2c<M>([&](long long r, int col) { return dz[r * 2 * g.C + col]; },
              dzs, dzt, g);
}

// ---------------------------------------------------------------------------
// The products
// ---------------------------------------------------------------------------

// Gate recompute for rows t0.. of sample b and channels n0 = 32 blockIdx.y
// ...: z = y[t-d] W0 + y[t] W1 + y[t+d] W2 + bd + cond (K1's gate product
// over ys and its packed wd, wp [P, 2Cp, 3Cp]); z [R, 2C] f32 out, and h =
// sigmoid(z_g) tanh(z_f) into ht [P, Cp, rp] as an operand, transposed.
template <class M>
__global__ void __launch_bounds__(THREADS)
regate_tc_kernel(const typename M::E* __restrict__ ys,
                 const typename M::E* __restrict__ wp,
                 const float* __restrict__ bd,
                 const typename M::E* __restrict__ cond,
                 float* __restrict__ z, typename M::E* __restrict__ ht, Geo g,
                 int d) {
  extern __shared__ uint8_t smem_raw[];
  const int t0 = blockIdx.x * BM, nt = blockIdx.y, b = blockIdx.z;
  const int cp = g.cp;
  const Gemm<typename M::E> op{
      ys + (size_t)b * g.T * cp, (size_t)g.R * cp, cp, g.T, t0, 3, cp, d,
      wp + (size_t)nt * BN * 3 * cp, (size_t)2 * cp * 3 * cp, 3 * cp, BN,
      3 * cp / M::BK};
  float acc[32];
  mainloop<M>(acc, op, ring_base(smem_raw));

  // the epilogue's loads first, all in flight together, then the math
  const int r0 = tc::acc_row(), cq = tc::acc_col(), n0 = nt * HALF;
  const size_t C2 = 2 * (size_t)g.C;
  float bg[8], bf[8], cg[16], cf[16];
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + r0 + 8 * (e >> 1), o = n0 + 8 * j + cq + (e & 1);
      const bool ok = t < g.T && o < g.C;
      const size_t row = (size_t)b * g.T + t;
      if (e < 2) {
        bg[2 * j + e] = o < g.C ? bd[o] : 0.f;
        bf[2 * j + e] = o < g.C ? bd[g.C + o] : 0.f;
      }
      cg[4 * j + e] = ok ? to_f(cond[row * C2 + o]) : 0.f;
      cf[4 * j + e] = ok ? to_f(cond[row * C2 + g.C + o]) : 0.f;
    }
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + r0 + 8 * (e >> 1), o = n0 + 8 * j + cq + (e & 1);
      if (t >= g.T || o >= g.C) continue;
      const size_t row = (size_t)b * g.T + t;
      const float zg = acc[4 * j + e] + bg[2 * j + (e & 1)] + cg[4 * j + e];
      const float zf = acc[4 * (j + HALF / 8) + e] + bf[2 * j + (e & 1)] +
                       cf[4 * j + e];
      z[row * C2 + o] = zg;
      z[row * C2 + g.C + o] = zf;
      store_op<M>(ht, (size_t)o * g.rp + pos_of(row, g), (size_t)cp * g.rp,
                  dsvc::sigmoidf_(zg) * tanhf(zf));
    }
}

// dh = rnd(do) wo^T for rows m0.. of the batch and channels n0..: A the
// operand rows dos [P, R, 2Cp], B wp [P, Cp, 2Cp] (wo packed); epilogue dz
// from z's pre-activations, dcp [R, 2C] = dz in DT, and, unless DT is f32
// (then dcp is dz), dz in place of z.  The operand forms of dz are
// stage_dz_kernel's: written from this epilogue's accumulator fragments
// they cost more than the product.
template <class M, typename DT>
__global__ void __launch_bounds__(THREADS)
dh_tc_kernel(const typename M::E* __restrict__ dos,
             const typename M::E* __restrict__ wp, float* __restrict__ z,
             DT* __restrict__ dcp, Geo g) {
  extern __shared__ uint8_t smem_raw[];
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN, cp = g.cp;
  const Gemm<typename M::E> op{
      dos, (size_t)g.R * 2 * cp, 2 * cp, g.R, m0, 1, 2 * cp, 0,
      wp + (size_t)n0 * 2 * cp, (size_t)cp * 2 * cp, 2 * cp, BN,
      2 * cp / M::BK};
  float acc[32];
  mainloop<M>(acc, op, ring_base(smem_raw));

  const int r0 = tc::acc_row(), cq = tc::acc_col();
  const size_t C2 = 2 * (size_t)g.C;
  float zg[32], zf[32];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long r = m0 + r0 + 8 * (e >> 1);
      const int c = n0 + 8 * j + cq + (e & 1);
      const bool ok = r < g.R && c < g.C;
      zg[4 * j + e] = ok ? z[r * C2 + c] : 0.f;
      zf[4 * j + e] = ok ? z[r * C2 + g.C + c] : 0.f;
    }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long r = m0 + r0 + 8 * (e >> 1);
      const int c = n0 + 8 * j + cq + (e & 1);
      if (r >= g.R || c >= g.C) continue;
      const float dh = acc[4 * j + e];
      const float s = dsvc::sigmoidf_(zg[4 * j + e]);
      const float tf = tanhf(zf[4 * j + e]);
      const float dg = dh * s * (1.f - s) * tf;
      const float df = dh * s * (1.f - tf * tf);
      const size_t ig = r * C2 + c, ifl = ig + g.C;
      if constexpr (!std::is_same_v<DT, float>) {
        z[ig] = dg;
        z[ifl] = df;
      }
      dcp[ig] = from_f<DT>(dg);
      dcp[ifl] = from_f<DT>(df);
    }
}

// dy[t] = dz[t+d] W0^T + dz[t] W1^T + dz[t-d] W2^T for rows t0.. of sample
// b and channels n0..: A the operand rows dzs [P, R, 2Cp] at rows t + (1 -
// j) d (zero outside the sample), B wp [P, Cp, 6Cp] (wd's taps packed);
// epilogue dy [R, C] out, dx <- dy + dx / sqrt2.
template <class M>
__global__ void __launch_bounds__(THREADS)
dy_tc_kernel(const typename M::E* __restrict__ dzs,
             const typename M::E* __restrict__ wp, float* __restrict__ dy,
             float* __restrict__ dx, Geo g, int d) {
  extern __shared__ uint8_t smem_raw[];
  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN, b = blockIdx.z;
  const int cp = g.cp;
  const Gemm<typename M::E> op{
      dzs + (size_t)b * g.T * 2 * cp, (size_t)g.R * 2 * cp, 2 * cp, g.T, t0,
      3, 2 * cp, -d, wp + (size_t)n0 * 6 * cp, (size_t)cp * 6 * cp, 6 * cp,
      BN, 6 * cp / M::BK};
  float acc[32];
  mainloop<M>(acc, op, ring_base(smem_raw));

  const int r0 = tc::acc_row(), cq = tc::acc_col();
  float xv[32];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + r0 + 8 * (e >> 1), c = n0 + 8 * j + cq + (e & 1);
      xv[4 * j + e] =
          t < g.T && c < g.C ? dx[((size_t)b * g.T + t) * g.C + c] : 0.f;
    }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + r0 + 8 * (e >> 1), c = n0 + 8 * j + cq + (e & 1);
      if (t >= g.T || c >= g.C) continue;
      const size_t idx = ((size_t)b * g.T + t) * g.C + c;
      dy[idx] = acc[4 * j + e];
      dx[idx] = acc[4 * j + e] + xv[4 * j + e] * kInvSqrt2;
    }
}

// Partial weight grad over chunk blockIdx.z: part[z][j C + c][h C + k] =
// sum over the chunk's positions of at[j Cp + c] bt[h Cp + k], A = at [P,
// taps Cp, rp] (h^T, or y's taps), B = bt [P, 2Cp, rp] (rnd(do)^T or
// rnd(dz)^T); the chunk's kc positions (zeros past its rows) are its K.
// K runs to 2048 here, so the CTA tile is 128 x 128 on two warpgroups:
// against 64 x 64 it reads a third less shared memory per product.
template <class M>
__global__ void __launch_bounds__(WG_WGS * THREADS, 1)
wgrad_tc_kernel(const typename M::E* __restrict__ at,
                const typename M::E* __restrict__ bt, float* __restrict__ part,
                int taps, Geo g) {
  extern __shared__ uint8_t smem_raw[];
  const int m0 = blockIdx.x * WG_WGS * BM, n0 = blockIdx.y * WG_NB;
  const int chunk = blockIdx.z, cp = g.cp;
  const size_t k0 = (size_t)chunk * g.kc;
  const Gemm<typename M::E> op{
      at + k0, (size_t)taps * cp * (size_t)g.rp, g.rp, (long long)taps * cp,
      m0, 1, g.kc, 0, bt + (size_t)n0 * (size_t)g.rp + k0,
      (size_t)2 * cp * (size_t)g.rp, g.rp, 2 * cp - n0, g.kc / M::BK};
  float acc[WG_NB / 2];
  mainloop<M, WG_WGS, WG_NB>(acc, op, ring_base(smem_raw));

  const int r0 = tc::acc_row(), cq = tc::acc_col();
  const size_t C2 = 2 * (size_t)g.C;
  float* out = part + (size_t)chunk * taps * g.C * C2;
#pragma unroll
  for (int j = 0; j < WG_NB / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + r0 + 8 * (e >> 1), n = n0 + 8 * j + cq + (e & 1);
      const int tap = m / cp, c = m - tap * cp, h = n / cp, k = n - h * cp;
      if (tap < taps && c < g.C && h < 2 && k < g.C)
        out[(size_t)(tap * g.C + c) * C2 + h * g.C + k] = acc[4 * j + e];
    }
}

// ---------------------------------------------------------------------------
// The ordered sums
// ---------------------------------------------------------------------------

// out[i] = sum_g (sum_k part[g * cps + k][i]), k and g in order
__global__ void sum_chunks_kernel(const float* __restrict__ part, int nseg,
                                  int cps, long long n,
                                  float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float tot = 0.f;
    for (int g = 0; g < nseg; ++g) {
      float s = 0.f;
      for (int k = 0; k < cps; ++k) s += part[((long long)g * cps + k) * n + i];
      tot += s;
    }
    out[i] = tot;
  }
}

// Column sums of src [G * group_rows, N] per group of rows, in two passes:
// part[g][c][n] = sum over chunk c (cch rows) of group g, then
// out[g][n] = sum_c part[g][c][n].
__global__ void colsum_part_kernel(const float* __restrict__ src, int N,
                                   int group_rows, int cch,
                                   float* __restrict__ part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y, g = blockIdx.z, nch = gridDim.y;
  if (n >= N) return;
  const long long r0 = (long long)g * group_rows + (long long)c * cch;
  const long long r1 = min((long long)(g + 1) * group_rows, r0 + cch);
  float s = 0.f;
  for (long long r = r0; r < r1; ++r) s += src[r * N + n];
  part[((long long)g * nch + c) * N + n] = s;
}

__global__ void colsum_final_kernel(const float* __restrict__ part, int N,
                                    int nch, int G, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= G * N) return;
  const int g = i / N, n = i - g * N;
  float s = 0.f;
  for (int c = 0; c < nch; ++c) s += part[((long long)g * nch + c) * N + n];
  out[i] = s;
}

int colsum(const float* src, int rows, int N, int group_rows, int cch,
           float* cpart, float* out, cudaStream_t s) {
  const int G = rows / group_rows, nch = (group_rows + cch - 1) / cch;
  colsum_part_kernel<<<dim3((N + 255) / 256, nch, G), 256, 0, s>>>(
      src, N, group_rows, cch, cpart);
  DSVC_LAUNCH_CHECK();
  colsum_final_kernel<<<(G * N + 255) / 256, 256, 0, s>>>(cpart, N, nch, G,
                                                          out);
  DSVC_LAUNCH_CHECK();
  return 0;
}

// blocks of 256 threads for a grid-stride loop over n elements
int grid1d(long long n) {
  const long long blocks = (n + 255) / 256, cap = 65535LL * 8;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

// Column sums over all rows of src [rows, N], per segment of seg_rows rows
// and then over the segments in order (gsum [rows / seg_rows, N] scratch,
// unused with one segment).
int colsum_segments(const float* src, int rows, int N, int seg_rows, int cch,
                    float* cpart, float* gsum, float* out, cudaStream_t s) {
  const int nseg = rows / seg_rows;
  int err = colsum(src, rows, N, seg_rows, cch, cpart, nseg == 1 ? out : gsum,
                   s);
  if (err || nseg == 1) return err;
  sum_chunks_kernel<<<grid1d(N), 256, 0, s>>>(gsum, nseg, 1, N, out);
  DSVC_LAUNCH_CHECK();
  return 0;
}

// The product-operand scratch of one layer, in mode M's E with M::P
// planes each, zeroed by the wrapper: ys [R, Cp], yt [3Cp, rp], ht [Cp,
// rp], dos and dzs [R, 2Cp], dot and dzt [2Cp, rp].
template <typename E>
struct Planes {
  E *ys, *yt, *ht, *dos, *dot, *dzs, *dzt;
};

// The backward.  In: xs [L,B,T,C], cond [L,B,T,2C] (E), sb [L,B,C] f32
// (contiguous), bd [L,2C] f32, dout [B,T,C] (GT); wdg [L,P,2Cp,3Cp] (K1's
// gate packing), wdh [L,P,Cp,2Cp] and wdy [L,P,Cp,6Cp], packed by the
// wrapper.  Out: dx [B,T,C] f32 (= dx0), dsb [L,B,C] f32, dcp [L,B,T,2C]
// (DT), dwd [L,3,C,2C], dbd [L,2C], dwo [L,C,2C], dbo [L,2C] f32.
// Scratch: z, do_ [B*T, 2C] f32; dy [B*T, C] f32; the planes; wpart
// [nchunk, 3C, 2C] f32; cpart [max((B*T / seg_rows) * ceil(seg_rows / cch)
// * 2C, B * ceil(T / cch) * C)] f32; gsum [B*T / seg_rows, 2C] f32 (unused
// when seg_rows = B*T).
template <class M, typename DT, typename GT>
int run_bwd(const typename M::E* xs, const float* sb,
            const typename M::E* cond, const typename M::E* wdg,
            const typename M::E* wdh, const typename M::E* wdy,
            const float* bd, const GT* dout, float* dx, float* dsb, DT* dcp,
            float* dwd, float* dbd, float* dwo, float* dbo, float* z,
            float* do_, float* dy, const Planes<typename M::E>& pl,
            float* wpart, float* cpart, float* gsum, int B, int T, int C,
            int L, int cycle, int seg_rows, int rch, int cch, const int* plan,
            cudaStream_t s) {
  if (plan == nullptr || seg_rows <= 0 || rch <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long R = (long long)B * T;
  const int span = seg_rows < rch ? seg_rows : rch;
  const Geo g{B, T, C, plan[Q_CP], R, seg_rows,
              (seg_rows + rch - 1) / rch, rch,
              (span + KC_ALIGN - 1) / KC_ALIGN * KC_ALIGN, plan[Q_RP]};
  if (!plan_ok<M>(plan, g)) return static_cast<int>(cudaErrorInvalidValue);
  const int cp = g.cp, smem = plan[Q_SMEM], smem_w = plan[Q_SMEM_W];
  const int nchunk = plan[Q_NCHUNK];
  const int nseg = static_cast<int>(R / seg_rows), C2 = 2 * C;
  int err = allow_smem(regate_tc_kernel<M>, smem);
  if (err == 0) err = allow_smem(dh_tc_kernel<M, DT>, smem);
  if (err == 0) err = allow_smem(dy_tc_kernel<M>, smem);
  if (err == 0) err = allow_smem(wgrad_tc_kernel<M>, smem_w);
  if (err != 0) return err;
  const long long RC = R * C, RC2 = R * C2;
  const size_t P = M::P;
  const dim3 tt(TT, TT_ROWS);
  const dim3 grid_y((R + TT - 1) / TT, cp / TT), grid_do(grid_y.x, 2 * cp / TT);
  const dim3 grid_gate(plan[Q_GRID_T], plan[Q_GRID_PAIR], B);
  const dim3 grid_dh(plan[Q_GRID_R], plan[Q_GRID_C]);
  const dim3 grid_dy(plan[Q_GRID_T], plan[Q_GRID_C], B);
  const dim3 grid_wo(plan[Q_GRID_WO], plan[Q_GRID_WN], nchunk);
  const dim3 grid_wd(plan[Q_GRID_WD], plan[Q_GRID_WN], nchunk);
  cudaError_t e = cudaMemsetAsync(dx, 0, RC * sizeof(float), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int l = L - 1; l >= 0; --l) {
    const int d = 1 << (l % cycle);
    const float* sb_l = sb + (long long)l * B * C;
    stage_y_kernel<M><<<grid_y, tt, 0, s>>>(xs + l * RC, sb_l, pl.ys, pl.yt,
                                            g, d);
    DSVC_LAUNCH_CHECK();
    regate_tc_kernel<M><<<grid_gate, THREADS, smem, s>>>(
        pl.ys, wdg + (size_t)l * P * 2 * cp * 3 * cp, bd + (long long)l * C2,
        cond + l * RC2, z, pl.ht, g, d);
    DSVC_LAUNCH_CHECK();
    make_do_kernel<M, GT><<<grid_do, tt, 0, s>>>(dx, dout, do_, pl.dos,
                                                 pl.dot, g);
    DSVC_LAUNCH_CHECK();
    dh_tc_kernel<M, DT><<<grid_dh, THREADS, smem, s>>>(
        pl.dos, wdh + (size_t)l * P * cp * 2 * cp, z, dcp + l * RC2, g);
    DSVC_LAUNCH_CHECK();
    const float* dz;   // f32 dz: dcp itself when it is stored in f32
    if constexpr (std::is_same_v<DT, float>)
      dz = dcp + l * RC2;
    else
      dz = z;
    stage_dz_kernel<M><<<grid_do, tt, 0, s>>>(dz, pl.dzs, pl.dzt, g);
    DSVC_LAUNCH_CHECK();
    dy_tc_kernel<M><<<grid_dy, THREADS, smem, s>>>(
        pl.dzs, wdy + (size_t)l * P * cp * 6 * cp, dy, dx, g, d);
    DSVC_LAUNCH_CHECK();
    wgrad_tc_kernel<M><<<grid_wo, WG_WGS * THREADS, smem_w, s>>>(
        pl.ht, pl.dot, wpart, 1, g);
    DSVC_LAUNCH_CHECK();
    sum_chunks_kernel<<<grid1d((long long)C * C2), 256, 0, s>>>(
        wpart, nseg, g.cps, (long long)C * C2, dwo + (long long)l * C * C2);
    DSVC_LAUNCH_CHECK();
    wgrad_tc_kernel<M><<<grid_wd, WG_WGS * THREADS, smem_w, s>>>(
        pl.yt, pl.dzt, wpart, 3, g);
    DSVC_LAUNCH_CHECK();
    sum_chunks_kernel<<<grid1d(3LL * C * C2), 256, 0, s>>>(
        wpart, nseg, g.cps, 3LL * C * C2, dwd + (long long)l * 3 * C * C2);
    DSVC_LAUNCH_CHECK();
    err = colsum_segments(do_, static_cast<int>(R), C2, seg_rows, cch, cpart,
                          gsum, dbo + (long long)l * C2, s);
    if (err) return err;
    err = colsum_segments(dz, static_cast<int>(R), C2, seg_rows, cch, cpart,
                          gsum, dbd + (long long)l * C2, s);
    if (err) return err;
    err = colsum(dy, static_cast<int>(R), C, T, cch, cpart,
                 dsb + (long long)l * B * C, s);
    if (err) return err;
  }
  return 0;
}

}  // namespace ttc
}  // namespace
