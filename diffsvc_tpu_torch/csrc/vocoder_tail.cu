// (NSF-)HiFiGAN generator tail (K3) for Hopper: each convolution of the
// tail as an implicit GEMM on the tensor cores, f32-accurate as 3xTF32
// split products (the arithmetic of diffnet_layer_tf32x3.cuh), on
// channels-last [B, T, C] f32 activations.
//
// Replaces diffsvc_tpu/ops/pallas/vocoder_tail.py:tail (kernel from
// _make_kernel).  The TPU kernel runs every stage from the first
// 128-channel stage through conv_post in one time-tiled program over a
// 128-lane packed layout held in VMEM; 227 KB of shared memory cannot hold
// that at 128 channels, so here the same plan is a host loop of three
// kernels, one launch per convolution or ResBlock1 pair:
//   conv_tc_kernel<BN>   y = conv(leaky(x, slope); dilation d, padding p) +
//                        bias [+ residual] [tanh]; written to out, or
//                        accumulated into a branch sum acc = (first ? 0 :
//                        acc) + y, divided by the branch count after the
//                        last branch (the resblock mean, in branch order)
//   convt_tc_kernel<BN>  y = conv_transpose(leaky(x, 0.1); stride u,
//                        padding (k-u)/2) + bias [+ NSF injection], one
//                        output phase (t + pad) mod u per grid.z slice: a
//                        dense conv over its ceil(k/u) input taps
//   pair_tc_kernel<BN>   a ResBlock1 pair, conv(1)(leaky(conv(d)(leaky x)))
//                        + x, its intermediate kept in shared memory, with
//                        conv_tc_kernel's epilogue (at N tiles up to 32: the
//                        bytes-bound 32- and 16-channel stages)
// BN, the N tile, is Cout padded to a power of two from 8 to 128 (128 /
// 64 / 32 / 16 at the openvpi stages, 8 for conv_post's Cout = 1), so each
// stage's launches are their own template instance in a profile.
//
// What bounds it on the H100: at 5 s of 44.1 kHz audio and the openvpi
// geometry the tail is 216.7 GFLOP, 1.31 ms at 3xTF32 (495/3 TFLOP/s);
// each conv reads one activation and writes one (14.1 MB at every stage),
// so the 128- and 64-channel stages are bound by the tensor cores and the
// 32- and 16-channel ones (28-56 FLOP per byte at k = 7) by bytes.  (On
// the H100 the narrow stages run far above their byte floor: at N = 16
// their time follows the count of m64n16k8 wgmmas, which
// tools/k3_variants.py shows by dropping two of the three products.)  What
// the design does about it:
// - Rows are one sample's time steps (grid.z = sample, or sample x phase),
//   N is the whole of Cout, so a CTA reads its input rows once per conv:
//   one halo'd window of x, rows [t0 - halo, t0 + BM + reach - halo), zero
//   outside [0, T), loaded once into shared memory by cp.async and put
//   through the leaky relu in place.  Every tap is a shifted view of it
//   (the TPU kernel's rolled taps over its halo'd VMEM tile).
// - A shift of j d rows is rarely a multiple of 8, which a swizzled A
//   descriptor cannot follow, so A comes from registers (wgmma's register
//   form for tf32): each thread loads its fragment from the unswizzled
//   window (row stride 8 or 24 mod 32 words: the half-warp's 8-byte loads
//   hit distinct banks) and splits it into hi = tf32(a), lo = tf32(a - hi)
//   in registers, so neither leaky(x) nor a lo plane reaches memory.  The
//   K columns of each k8 step are permuted (K8_PERM in the wrapper) so that
//   a thread's two k positions are adjacent channels: one 8-byte load.
// - B, the weights, are split into hi and lo planes and packed K-major once
//   per plan by the wrapper (ops/hopper/vocoder_tail.py:pack_conv,
//   pack_convt), and stream through a 3-deep ring of 32-deep K blocks in
//   the 128-byte swizzled layout of the tf32 descriptors, two blocks ahead.
// - Per k8 step a_lo b_hi, a_hi b_lo, then a_hi b_hi; each 32-deep K block
//   sums in a fresh accumulator (scale-d = 0 on its first wgmma) and is
//   added into the total with f32 adds, as K1's f32 route does.
// - BM = 128 rows (two warpgroups sharing the window and the B ring) where
//   shared memory allows, else 64: the widest conv (128 channels, k = 11,
//   d = 5) takes (128 + 50) x 136 x 4 B of window and 96 KB of ring.
// - At the narrow, bytes-bound stages a ResBlock1 pair runs as one launch,
//   which halves their launches and activation round trips: the CTA makes
//   128 intermediate rows and writes the 128 - (k - 1) output rows they
//   cover.  At 64 channels, bound by the products, two launches were
//   faster on the H100.
// The launch plan (tiles, window, shared memory, grid; the fields P_*) is
// computed by the wrapper (ops/hopper/vocoder_tail.py:tile_plan) and
// checked here.
#include "wgmma.cuh"

namespace {
namespace tail {

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
using wg::tf32_rna;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_wait;

constexpr int BK = 32;          // K per block: one 128-byte swizzle row of f32
constexpr int STAGES = 3;       // the ring of B blocks
constexpr int PREFETCH = STAGES - 1;
constexpr int WG_ROWS = 64;     // rows per warpgroup: one wgmma M
constexpr int WG_THREADS = 128;
constexpr int SMEM_MAX = 232448;

// The wrapper's plan, in this order (ops/hopper/vocoder_tail.py
// PLAN_FIELDS).
enum {
  P_BN, P_NP, P_CIN_P, P_LDA, P_KP, P_TAPS, P_STEP, P_HALO, P_BM,
  P_WIN_ROWS, P_THREADS, P_SMEM, P_GRID_M, P_GRID_N, P_GRID_Z
};

// Bytes of one ring stage: the hi and the lo tile of BN rows x 128 bytes.
__host__ __device__ constexpr int slot_bytes(int bn) { return 2 * bn * BK * 4; }

// The plan matches these kernels' tiles and covers `rows` output rows per
// sample and phase of Cin -> Cout channels, with grid.z = `slices`.
inline bool plan_ok(const int* p, int rows, int slices, int Cin, int Cout) {
  if (p == nullptr) return false;
  const int bn = p[P_BN], np = p[P_NP], cin_p = p[P_CIN_P], lda = p[P_LDA];
  const int taps = p[P_TAPS], step = p[P_STEP], bm = p[P_BM];
  if (bn != 8 && bn != 16 && bn != 32 && bn != 64 && bn != 128) return false;
  if (np % bn != 0 || np < Cout || np - Cout >= bn) return false;
  if (cin_p % 8 != 0 || cin_p < Cin || cin_p - Cin >= 8) return false;
  if (lda < cin_p || lda % 8 != 0) return false;
  if (taps < 1 || step < 1 || p[P_HALO] < 0) return false;
  if (p[P_KP] % BK != 0 || p[P_KP] < taps * cin_p ||
      p[P_KP] - taps * cin_p >= BK)
    return false;
  if ((bm != WG_ROWS && bm != 2 * WG_ROWS) ||
      p[P_THREADS] != bm / WG_ROWS * WG_THREADS)
    return false;
  if (p[P_WIN_ROWS] != bm + (taps - 1) * step) return false;
  if (p[P_SMEM] < ALIGN + STAGES * slot_bytes(bn) + p[P_WIN_ROWS] * lda * 4 ||
      p[P_SMEM] > SMEM_MAX)
    return false;
  return p[P_GRID_M] == (rows + bm - 1) / bm && p[P_GRID_N] * bn == np &&
         p[P_GRID_Z] == slices;
}

// What a CTA's product reads: the window geometry and the weights of its
// N tile (hi plane; the lo plane `plane` floats on).
struct Geo {
  int T;          // input rows per sample
  int Cin, cin_p, lda;
  int taps, step;
  int kp;
  int win_rows;
  int vec;        // x rows start 16-byte aligned: load by cp.async
  size_t plane;   // np * kp
};

// d[64 x N] = A[64 x 8] B[N x 8]^T + (scale_d ? d : 0): A from registers
// (a[0..3] = A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] for lane
// 4g + t of each warp's 16 rows), B K-major in shared memory, TF32
// operands, f32 accumulators laid out as in tc::wgmma_m64n64k16 (thread
// holds d[4j + 2i + c] = D[16w + g + 8i, 8j + 2t + c]).  One overload per
// N tile.
__device__ __forceinline__ void mma_rs(float (&d)[4],
                                       const uint32_t (&a)[4],
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_rs(float (&d)[8],
                                       const uint32_t (&a)[4],
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_rs(float (&d)[16],
                                       const uint32_t (&a)[4],
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_rs(float (&d)[32],
                                       const uint32_t (&a)[4],
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_rs(float (&d)[64],
                                       const uint32_t (&a)[4],
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


// a split into TF32 hi and lo parts, as the bits wgmma reads.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_rna(a);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32_rna(a - h));
}

// This thread's cp.async copies of K block kb of the weights (rows of this
// N tile, hi plane at w) into a ring slot: hi tile, then lo tile.
template <int BN>
__device__ __forceinline__ void load_b(const float* w, const Geo& g, int kb,
                                       uint32_t slot) {
  for (int e = threadIdx.x; e < BN * 8; e += blockDim.x) {
    const int r = e >> 3, ch = e & 7;
    const float* src = w + (size_t)r * g.kp + kb * BK + ch * 4;
    cp_async16(slot + swz(r, ch), src, true);
    cp_async16(slot + BN * BK * 4 + swz(r, ch), src + g.plane, true);
  }
}

// The window: rows w0 .. w0 + win_rows of sample x (input rows; zero
// outside [0, T)), channels 0 .. cin_p (zero past Cin), row stride lda.
// By cp.async where rows are 16-byte aligned, else by plain loads.
__device__ __forceinline__ void load_window(float* win, const float* x,
                                            const Geo& g, int w0) {
  if (g.vec) {
    const int cpr = g.cin_p / 4;
    const uint32_t base = smem_u32(win);
    for (int e = threadIdx.x; e < g.win_rows * cpr; e += blockDim.x) {
      const int r = e / cpr, ch = e - r * cpr, t = w0 + r;
      const bool ok = t >= 0 && t < g.T && ch * 4 < g.Cin;
      cp_async16(base + (r * g.lda + ch * 4) * 4,
                 ok ? x + (size_t)t * g.Cin + ch * 4 : x, ok);
    }
  } else {
    for (int e = threadIdx.x; e < g.win_rows * g.cin_p; e += blockDim.x) {
      const int r = e / g.cin_p, c = e - r * g.cin_p, t = w0 + r;
      win[r * g.lda + c] =
          t >= 0 && t < g.T && c < g.Cin ? x[(size_t)t * g.Cin + c] : 0.f;
    }
  }
}

// The leaky relu, in place, over the window's cin_p channels.
__device__ __forceinline__ void leaky_window(float* win, const Geo& g,
                                             float slope) {
  for (int e = threadIdx.x; e < g.win_rows * g.cin_p; e += blockDim.x) {
    float& v = win[(e / g.cin_p) * g.lda + e % g.cin_p];
    v = v > 0.f ? v : v * slope;
  }
}

// The first PREFETCH blocks of the weights into the ring, one cp.async
// group each (empty past the last block).
template <int BN>
__device__ __forceinline__ void start_b(const float* w, const Geo& g,
                                        uint32_t ring) {
#pragma unroll
  for (int s = 0; s < PREFETCH; ++s) {
    if (s < g.kp / BK) load_b<BN>(w, g, s, ring + s * slot_bytes(BN));
    cp_async_commit();
  }
}

// A fragments of one 32-deep K block: this thread's rows of the window at
// its four k8 steps, from (tap, c0) on, split into hi and lo; advances
// (tap, c0).  k8 steps past the taps (K padded to a whole block) multiply
// zero columns of B: they read the last tap again, so A stays finite and
// every warpgroup issues all 12 wgmmas of a block (a wgmma under a branch
// makes ptxas serialize them all).
__device__ __forceinline__ void load_frags(uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4],
                                           const float* a_row, const Geo& g,
                                           int& tap, int& c0) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float* p = a_row + min(tap, g.taps - 1) * g.step * g.lda + c0;
    const float2 u = *reinterpret_cast<const float2*>(p);
    const float2 v = *reinterpret_cast<const float2*>(p + 8 * g.lda);
    split(u.x, hi[s][0], lo[s][0]);
    split(v.x, hi[s][1], lo[s][1]);
    split(u.y, hi[s][2], lo[s][2]);
    split(v.y, hi[s][3], lo[s][3]);
    c0 += 8;
    if (c0 == g.cin_p) {
      c0 = 0;
      ++tap;
    }
  }
}

// acc = win * W over all taps, in 3xTF32, after start_b: per 32-deep K
// block each warpgroup loads its A fragments (rows 16 warp + g and + 8,
// window row r + tap step), splits them, issues the block's 12 wgmmas into
// blk and adds blk into acc.  The ring slot a load overwrites was read by
// the previous block's wgmmas, which every thread waited for before the
// barrier that precedes the load.  The window's writes before the call are
// ordered by the first block's barrier; the ring is free again on return.
template <int BN>
__device__ __forceinline__ void mma_loop(float (&acc)[BN / 2],
                                         const float* win, const float* w,
                                         const Geo& g, uint32_t ring) {
  constexpr uint32_t SLOT = slot_bytes(BN);
  const int nk = g.kp / BK;
  const int lane = threadIdx.x & 31;
  const float* a_row =
      win + (16 * (threadIdx.x >> 5) + (lane >> 2)) * g.lda + 2 * (lane & 3);
  float blk[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = blk[i] = 0.f;
  int tap = 0, c0 = 0;   // the next k8 step's tap and first channel
  for (int kb = 0; kb < nk; ++kb) {
    cp_async_wait<PREFETCH - 1>();
    fence_proxy_async();
    __syncthreads();
    const int nxt = kb + PREFETCH;
    if (nxt < nk) load_b<BN>(w, g, nxt, ring + (nxt % STAGES) * SLOT);
    cp_async_commit();
    uint32_t hi[4][4], lo[4][4];
    load_frags(hi, lo, a_row, g, tap, c0);
    const uint32_t st = ring + (kb % STAGES) * SLOT;
    fence_acc(blk);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t o = 32 * s;
      mma_rs(blk, lo[s], desc(st + o), s > 0);
      mma_rs(blk, hi[s], desc(st + BN * BK * 4 + o), 1);
      mma_rs(blk, hi[s], desc(st + o), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(blk);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += blk[i];
  }
  cp_async_wait<0>();
  __syncthreads();
}

// acc = leaky(x, slope) * W for one CTA: the window of sample x from input
// row w0 (its own cp.async group, ahead of the first weight blocks), put
// through the leaky relu in place, then the product.  Returns the window.
template <int BN>
__device__ __forceinline__ float* conv_product(float (&acc)[BN / 2],
                                               uint8_t* smem_raw,
                                               const float* x,
                                               const float* w, const Geo& g,
                                               int w0, float slope) {
  const uint32_t pad = align_pad(smem_raw);
  const uint32_t ring = smem_u32(smem_raw) + pad;
  float* win = reinterpret_cast<float*>(smem_raw + pad +
                                        STAGES * slot_bytes(BN));
  load_window(win, x, g, w0);
  cp_async_commit();
  start_b<BN>(w, g, ring);
  cp_async_wait<PREFETCH>();
  __syncthreads();
  leaky_window(win, g, slope);
  mma_loop<BN>(acc, win, w, g, ring);
  return win;
}

// Conv: output rows t0 = BM blockIdx.x .. of sample blockIdx.z, channels
// n0 = BN blockIdx.y ...; the window starts `halo` (= the padding) rows
// before t0.  wp [2, np, kp]; out / res / acc [B, T, Cout].
template <int BN>
__global__ void __launch_bounds__(2 * WG_THREADS)
conv_tc_kernel(const float* __restrict__ x, const float* __restrict__ wp,
               const float* __restrict__ bias, float* __restrict__ out,
               const float* __restrict__ res, float* __restrict__ acc_out,
               int acc_first, float acc_div, int Cout, int halo, float slope,
               int use_tanh, Geo g) {
  extern __shared__ uint8_t smem_raw[];
  const int bm = blockDim.x / WG_THREADS * WG_ROWS;
  const int t0 = blockIdx.x * bm, n0 = blockIdx.y * BN, b = blockIdx.z;
  float acc[BN / 2];
  conv_product<BN>(acc, smem_raw, x + (size_t)b * g.T * g.Cin,
                   wp + (size_t)n0 * g.kp, g, t0 - halo, slope);

  const int r0 = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
  const int cq = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + r0 + 8 * (e >> 1), o = n0 + 8 * j + cq + (e & 1);
      if (t >= g.T || o >= Cout) continue;
      const size_t idx = ((size_t)b * g.T + t) * Cout + o;
      float y = acc[4 * j + e] + bias[o];
      if (res != nullptr) y += res[idx];
      if (use_tanh) y = tanhf(y);
      if (acc_out != nullptr) {
        float s = acc_first ? y : acc_out[idx] + y;
        if (acc_div > 0.f) s = s / acc_div;
        acc_out[idx] = s;
      } else {
        out[idx] = y;
      }
    }
}

// Transposed conv, output phase ph = blockIdx.z % u of sample blockIdx.z /
// u: rows s = BM blockIdx.x + r give output t = s u + ph - pad, and tap q
// reads input row s - (taps - 1) + q (the window starts taps - 1 rows
// before s0).  wp [u, 2, np, kp]; inj (optional) [B, inj_T, Cout]; out
// [B, Tout, Cout].
template <int BN>
__global__ void __launch_bounds__(2 * WG_THREADS)
convt_tc_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                const float* __restrict__ bias, const float* __restrict__ inj,
                int inj_T, float* __restrict__ out, int Tout, int Cout,
                int u, int pad, float slope, Geo g) {
  extern __shared__ uint8_t smem_raw[];
  const int bm = blockDim.x / WG_THREADS * WG_ROWS;
  const int s0 = blockIdx.x * bm, n0 = blockIdx.y * BN;
  const int b = blockIdx.z / u, ph = blockIdx.z - b * u;
  float acc[BN / 2];
  conv_product<BN>(acc, smem_raw, x + (size_t)b * g.T * g.Cin,
                   wp + (size_t)ph * 2 * g.plane + (size_t)n0 * g.kp, g,
                   s0 - (g.taps - 1), slope);

  const int r0 = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
  const int cq = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int to = (s0 + r0 + 8 * (e >> 1)) * u + ph - pad;
      const int o = n0 + 8 * j + cq + (e & 1);
      if (to < 0 || to >= Tout || o >= Cout) continue;
      float y = acc[4 * j + e] + bias[o];
      if (inj != nullptr) y += inj[((size_t)b * inj_T + to) * Cout + o];
      out[((size_t)b * Tout + to) * Cout + o] = y;
    }
}

// A ResBlock1 pair in one launch: y = conv2(leaky(conv1(leaky(x)))) + x
// with conv1 of dilation d and conv2 of dilation 1, both k taps, C -> C
// channels in one N tile.  Output rows t0 = bm_out blockIdx.x .. t0 +
// bm_out of sample blockIdx.z, bm_out = bm - (k - 1): the CTA computes the
// intermediate z for the bm rows [t0 - halo2, t0 + bm - halo2) from a
// window of x, keeps leaky(z) in shared memory, zero at rows outside [0, T)
// (what conv2's zero padding reads there; conv1 of zeros plus its bias is
// not zero), and runs conv2 over it.  z's rows past bm stay zero: they
// feed only output rows past bm_out, which are not written.  Epilogue as
// conv_tc_kernel's with the residual x.  g1: x's window and conv1's
// weights; g2: z's window and conv2's weights.
template <int BN>
__global__ void __launch_bounds__(2 * WG_THREADS)
pair_tc_kernel(const float* __restrict__ x, const float* __restrict__ wp1,
               const float* __restrict__ b1, const float* __restrict__ wp2,
               const float* __restrict__ b2, float* __restrict__ out,
               float* __restrict__ acc_out, int acc_first, float acc_div,
               int halo1, int halo2, float slope, Geo g1, Geo g2) {
  extern __shared__ uint8_t smem_raw[];
  const int bm = blockDim.x / WG_THREADS * WG_ROWS, C = g1.Cin;
  const int t0 = blockIdx.x * (bm - 2 * halo2), b = blockIdx.z;
  const float* xb = x + (size_t)b * g1.T * C;
  float acc[BN / 2];
  const float* win = conv_product<BN>(acc, smem_raw, xb, wp1, g1,
                                      t0 - halo2 - halo1, slope);
  float* z = const_cast<float*>(win) + g1.win_rows * g1.lda;
  const uint32_t ring = smem_u32(smem_raw) + align_pad(smem_raw);
  start_b<BN>(wp2, g2, ring);   // conv2's first blocks load during this

  const int r0 = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
  const int cq = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = r0 + 8 * (e >> 1), o = 8 * j + cq + (e & 1);
      const int t = t0 - halo2 + m;
      if (o >= g2.cin_p) continue;
      float v = 0.f;
      if (t >= 0 && t < g1.T && o < C) {
        v = acc[4 * j + e] + b1[o];
        v = v > 0.f ? v : v * slope;
      }
      z[m * g2.lda + o] = v;
    }
  for (int e = threadIdx.x; e < (g2.win_rows - bm) * g2.cin_p;
       e += blockDim.x)
    z[(bm + e / g2.cin_p) * g2.lda + e % g2.cin_p] = 0.f;
  mma_loop<BN>(acc, z, wp2, g2, ring);

#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e >> 1), o = 8 * j + cq + (e & 1);
      const int t = t0 + r;
      if (r >= bm - 2 * halo2 || t >= g1.T || o >= C) continue;
      const size_t idx = ((size_t)b * g1.T + t) * C + o;
      const float y = acc[4 * j + e] + b2[o] + xb[(size_t)t * C + o];
      if (acc_out != nullptr) {
        float s = acc_first ? y : acc_out[idx] + y;
        if (acc_div > 0.f) s = s / acc_div;
        acc_out[idx] = s;
      } else {
        out[idx] = y;
      }
    }
}

// The pair's plan, in this order (ops/hopper/vocoder_tail.py
// PAIR_FIELDS).
enum {
  Q_BN, Q_CIN_P, Q_LDA, Q_TAPS, Q_STEP1, Q_HALO1, Q_KP1, Q_KP2, Q_HALO2,
  Q_BM, Q_BM_OUT, Q_WIN1, Q_WIN2, Q_THREADS, Q_SMEM, Q_GRID_M, Q_GRID_Z
};

// The pair plan matches the kernel's tiles and covers [B, T, C].
inline bool pair_ok(const int* p, int T, int B, int C) {
  if (p == nullptr) return false;
  const int bn = p[Q_BN], cin_p = p[Q_CIN_P], lda = p[Q_LDA];
  const int k = p[Q_TAPS], d = p[Q_STEP1], bm = p[Q_BM];
  if (bn != 8 && bn != 16 && bn != 32) return false;   // PAIR_MAX_BN
  if (C > bn || cin_p % 8 != 0 || cin_p < C || cin_p - C >= 8 ||
      cin_p > bn || lda < cin_p || lda % 8 != 0)
    return false;
  if (k < 1 || k % 2 == 0 || d < 1 || 2 * p[Q_HALO1] != (k - 1) * d ||
      2 * p[Q_HALO2] != k - 1)
    return false;
  const auto kp_ok = [&](int kp) {
    return kp % BK == 0 && kp >= k * cin_p && kp - k * cin_p < BK;
  };
  if (!kp_ok(p[Q_KP1]) || !kp_ok(p[Q_KP2])) return false;
  if ((bm != WG_ROWS && bm != 2 * WG_ROWS) ||
      p[Q_THREADS] != bm / WG_ROWS * WG_THREADS ||
      p[Q_BM_OUT] != bm - (k - 1) || p[Q_BM_OUT] < 1)
    return false;
  if (p[Q_WIN1] != bm + (k - 1) * d || p[Q_WIN2] != bm + k - 1) return false;
  if (p[Q_SMEM] < ALIGN + STAGES * slot_bytes(bn) +
                      (p[Q_WIN1] + p[Q_WIN2]) * lda * 4 ||
      p[Q_SMEM] > SMEM_MAX)
    return false;
  return p[Q_GRID_M] == (T + p[Q_BM_OUT] - 1) / p[Q_BM_OUT] &&
         p[Q_GRID_Z] == B;
}

Geo geo(const int* p, const void* x, int T, int Cin) {
  return Geo{T, Cin, p[P_CIN_P], p[P_LDA], p[P_TAPS], p[P_STEP], p[P_KP],
             p[P_WIN_ROWS],
             Cin % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0,
             (size_t)p[P_NP] * p[P_KP]};
}

template <int BN>
int launch_conv(const int* p, const float* x, const float* wp,
                const float* bias, float* out, const float* res,
                float* acc, int acc_first, float acc_div, int T, int Cin,
                int Cout, float slope, int use_tanh, cudaStream_t s) {
  // every instance may use up to SMEM_MAX bytes (set once per instance)
  static const int e = allow_smem(conv_tc_kernel<BN>, SMEM_MAX);
  if (e != 0) return e;
  const dim3 grid(p[P_GRID_M], p[P_GRID_N], p[P_GRID_Z]);
  conv_tc_kernel<BN><<<grid, p[P_THREADS], p[P_SMEM], s>>>(
      x, wp, bias, out, res, acc, acc_first, acc_div, Cout, p[P_HALO], slope,
      use_tanh, geo(p, x, T, Cin));
  DSVC_LAUNCH_CHECK();
  return 0;
}

template <int BN>
int launch_convt(const int* p, const float* x, const float* wp,
                 const float* bias, const float* inj, int inj_T, float* out,
                 int Tin, int Tout, int Cin, int Cout, int u, int pad,
                 float slope, cudaStream_t s) {
  static const int e = allow_smem(convt_tc_kernel<BN>, SMEM_MAX);
  if (e != 0) return e;
  const dim3 grid(p[P_GRID_M], p[P_GRID_N], p[P_GRID_Z]);
  convt_tc_kernel<BN><<<grid, p[P_THREADS], p[P_SMEM], s>>>(
      x, wp, bias, inj, inj_T, out, Tout, Cout, u, pad, slope,
      geo(p, x, Tin, Cin));
  DSVC_LAUNCH_CHECK();
  return 0;
}

template <int BN>
int launch_pair(const int* p, const float* x, const float* wp1,
                const float* b1, const float* wp2, const float* b2,
                float* out, float* acc, int acc_first, float acc_div, int T,
                int C, float slope, cudaStream_t s) {
  static const int e = allow_smem(pair_tc_kernel<BN>, SMEM_MAX);
  if (e != 0) return e;
  const int k = p[Q_TAPS];
  const Geo g1{T, C, p[Q_CIN_P], p[Q_LDA], k, p[Q_STEP1], p[Q_KP1],
               p[Q_WIN1],
               C % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0,
               (size_t)p[Q_BN] * p[Q_KP1]};
  const Geo g2{T, C, p[Q_CIN_P], p[Q_LDA], k, 1, p[Q_KP2], p[Q_WIN2], 0,
               (size_t)p[Q_BN] * p[Q_KP2]};
  const dim3 grid(p[Q_GRID_M], 1, p[Q_GRID_Z]);
  pair_tc_kernel<BN><<<grid, p[Q_THREADS], p[Q_SMEM], s>>>(
      x, wp1, b1, wp2, b2, out, acc, acc_first, acc_div, p[Q_HALO1],
      p[Q_HALO2], slope, g1, g2);
  DSVC_LAUNCH_CHECK();
  return 0;
}

}  // namespace tail
}  // namespace

extern "C" {

// x [B,T,Cin]; wp [2,np,kp] (hi, lo) packed by the wrapper; bias [Cout];
// res (optional) [B,T,Cout]; writes out [B,T,Cout], or accumulates into
// acc [B,T,Cout] when acc != 0.  The conv keeps the length: the plan's halo
// is the padding, 2 halo = (taps - 1) step.
int dsvc_tail_conv(const void* x, const void* wp, const void* bias,
                   void* out, const void* res, void* acc, int acc_first,
                   float acc_div, int B, int T, int Cin, int Cout,
                   float slope, int use_tanh, const int* plan, void* stream) {
  using namespace tail;
  if (!plan_ok(plan, T, B, Cin, Cout) ||
      2 * plan[P_HALO] != (plan[P_TAPS] - 1) * plan[P_STEP])
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xf = static_cast<const float*>(x);
  const auto wf = static_cast<const float*>(wp);
  const auto bf = static_cast<const float*>(bias);
  const auto of = static_cast<float*>(out);
  const auto rf = static_cast<const float*>(res);
  const auto af = static_cast<float*>(acc);
#define DSVC_CONV(BN)                                                     \
  case BN:                                                                \
    return launch_conv<BN>(plan, xf, wf, bf, of, rf, af, acc_first,       \
                           acc_div, T, Cin, Cout, slope, use_tanh, s);
  switch (plan[P_BN]) {
    DSVC_CONV(8)
    DSVC_CONV(16)
    DSVC_CONV(32)
    DSVC_CONV(64)
    DSVC_CONV(128)
  }
#undef DSVC_CONV
  return cudaErrorInvalidValue;
}

// x [B,Tin,Cin]; wp [u,2,np,kp] packed per output phase by the wrapper;
// inj (optional) [B,inj_T,Cout] with inj_T >= Tout; out [B,Tout,Cout].
int dsvc_tail_convt(const void* x, const void* wp, const void* bias,
                    const void* inj, int inj_T, void* out, int B, int Tin,
                    int Tout, int Cin, int Cout, int u, int pad, float slope,
                    const int* plan, void* stream) {
  using namespace tail;
  if (u < 1 || pad < 0 ||
      !plan_ok(plan, (Tout - 1 + pad) / u + 1, B * u, Cin, Cout) ||
      plan[P_STEP] != 1 || plan[P_HALO] != plan[P_TAPS] - 1)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xf = static_cast<const float*>(x);
  const auto wf = static_cast<const float*>(wp);
  const auto bf = static_cast<const float*>(bias);
  const auto jf = static_cast<const float*>(inj);
  const auto of = static_cast<float*>(out);
#define DSVC_CONVT(BN)                                                    \
  case BN:                                                                \
    return launch_convt<BN>(plan, xf, wf, bf, jf, inj_T, of, Tin, Tout,   \
                            Cin, Cout, u, pad, slope, s);
  switch (plan[P_BN]) {
    DSVC_CONVT(8)
    DSVC_CONVT(16)
    DSVC_CONVT(32)
    DSVC_CONVT(64)
    DSVC_CONVT(128)
  }
#undef DSVC_CONVT
  return cudaErrorInvalidValue;
}

// A ResBlock1 pair: x [B,T,C]; wp1, wp2 [2,np,kp1|kp2] (np = the N tile);
// b1, b2 [C]; writes out [B,T,C] = conv2(leaky(conv1(leaky x))) + x, or
// accumulates it into acc [B,T,C] when acc != 0 (as dsvc_tail_conv).
int dsvc_tail_pair(const void* x, const void* wp1, const void* b1,
                   const void* wp2, const void* b2, void* out, void* acc,
                   int acc_first, float acc_div, int B, int T, int C,
                   float slope, const int* plan, void* stream) {
  using namespace tail;
  if (!pair_ok(plan, T, B, C)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xf = static_cast<const float*>(x);
  const auto w1 = static_cast<const float*>(wp1);
  const auto c1 = static_cast<const float*>(b1);
  const auto w2 = static_cast<const float*>(wp2);
  const auto c2 = static_cast<const float*>(b2);
  const auto of = static_cast<float*>(out);
  const auto af = static_cast<float*>(acc);
#define DSVC_PAIR(BN)                                                     \
  case BN:                                                                \
    return launch_pair<BN>(plan, xf, w1, c1, w2, c2, of, af, acc_first,   \
                           acc_div, T, C, slope, s);
  switch (plan[Q_BN]) {
    DSVC_PAIR(8)
    DSVC_PAIR(16)
    DSVC_PAIR(32)
  }
#undef DSVC_PAIR
  return cudaErrorInvalidValue;
}

}  // extern "C"
