// One gated residual layer of DiffNet at bf16 on Hopper's tensor cores
// (K1's bf16 route; K2 runs it once per evaluation; the training forward,
// diffnet_stack_train.cu, runs it with an f32 state; the single block K6,
// diffnet_block.cu, its y0 and gate kernels).  Replaces, for bf16
// operands, diffsvc_tpu/ops/pallas/diffnet_stack.py:residual_stack (kernel
// _kernel), whose products all take bf16 operands with an f32 sum: exactly
// what wgmma computes.  Per layer l, with d = 2^(l mod cycle):
//   y = bf16(x + sb_l)                              (staged, see below)
//   z = y[t-d] W0 + y[t] W1 + y[t+d] W2 + bd + cond_l   (zeros outside [0,T))
//   h = bf16(sigmoid(z[:C]) * tanh(z[C:]))
//   o = h wo + bo
//   x <- bf16((x + o[:C]) / sqrt(2));   skip += o[C:] (f32)
//
// What bounds it on the H100: tensor-core operations.  At T=1024, C=384,
// L=20 one stack is 48.3 GFLOP (16 C^2 per row and layer) against ~31 MB
// of operands, ~1,500 FLOP per byte, five times the card's balance point.
// What the design does about it:
// - Both products are wgmma.mma_async m64n64k16 (bf16 operands, f32
//   accumulators), one warpgroup per CTA.  Operands reach shared memory
//   through a 4-stage cp.async ring in the 128-byte swizzled K-major layout
//   that wgmma's descriptors read (64 rows x 64 bf16 per tile), filled two
//   blocks ahead while one wgmma group stays in flight.
// - At these sizes a layer launch is latency-bound (~10 us of ~25 us is
//   fixed at T=1024): each epilogue issues all its global loads before
//   any math, so they are in flight together.
// - The weights are packed once per call by the wrapper (K-major, padded
//   to Cp = C rounded up to 64), with the gate columns o and the filter
//   columns C+o of 32 channels in one 64-wide N tile, and likewise the
//   residual and skip columns of the output projection.  A thread then
//   holds z_gate and z_filter (or res and skip) of the same (row, channel)
//   in its accumulators: the gated product never leaves registers.
// - The output kernel of layer l also writes y_{l+1} = bf16(x_{l+1} +
//   sb_{l+1}) into a [B, T, Cp] buffer (rounded once, from f32), so the gate
//   kernel loads its three taps as plain tiles of y at rows t-d, t, t+d;
//   tiles never cross a sample, and rows outside [0, T) of their own sample
//   are zero-filled by cp.async.  Channels C..Cp of y and h stay zero.
// - BM = 64 rows: at B=1, T=1024, C=384 a layer launches 16 x 12 = 192
//   CTAs of 66.5 KB shared memory (three fit an SM), 96 at T=512.
// The launch plan (tiles, stages, shared memory, grid, padding) is computed
// by the wrapper (ops/hopper/diffnet_stack.py:tc_plan) and checked here.
#pragma once

#include "wgmma.cuh"

// Internal linkage: diffnet_stack.cu and plms_ladder.cu both include this
// header and link into one library.
namespace {
namespace tc {

using bf16 = __nv_bfloat16;
using dsvc::to_f;

constexpr int BM = 64;          // rows per CTA: one wgmma M
constexpr int BN = 64;          // wgmma N
constexpr int HALF = BN / 2;    // channels per paired N tile (K1)
constexpr int BK = 64;          // K per stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int THREADS = 128;    // one warpgroup
constexpr int TILE = BM * BK * 2;   // bytes of one 64 x 64 bf16 tile
constexpr int ALIGN = 1024;     // the 128-byte swizzle repeats every 1 KB
constexpr int SMEM_MAX = 232448;

// The wrapper's plan, in this order (ops/hopper/diffnet_stack.py
// PLAN_FIELDS).
enum {
  P_CP, P_MP, P_BM, P_BN, P_BK, P_STAGES, P_THREADS, P_GRID_M,
  P_GRID_N_LAYER, P_GRID_N_IN, P_SMEM_LAYER, P_SMEM_IN, P_SMEM_EPI
};

constexpr int smem_layer() { return STAGES * 2 * TILE + ALIGN; }

// The plan matches the kernels' compile-time tiles and covers [B, T, C]
// (and M for the ladder's projections, when m > 0).
inline bool plan_ok(const int* p, int T, int C, int M) {
  if (p == nullptr || p[P_BM] != BM || p[P_BN] != BN || p[P_BK] != BK ||
      p[P_STAGES] != STAGES || p[P_THREADS] != THREADS)
    return false;
  const int cp = p[P_CP];
  if (cp % BK != 0 || cp < C || cp - C >= BK) return false;
  if (p[P_GRID_M] != (T + BM - 1) / BM || p[P_GRID_N_LAYER] * HALF != cp)
    return false;
  if (p[P_SMEM_LAYER] < smem_layer() || p[P_SMEM_LAYER] > SMEM_MAX)
    return false;
  if (M <= 0) return true;
  const int mp = p[P_MP];
  return mp % BK == 0 && mp >= M && mp - M < BK &&
         p[P_GRID_N_IN] * BN == cp &&
         p[P_SMEM_IN] >= 2 * (mp / BK) * TILE + ALIGN &&
         p[P_SMEM_IN] <= SMEM_MAX &&
         p[P_SMEM_EPI] >= (2 * (cp / BK) + STAGES) * TILE + ALIGN &&
         p[P_SMEM_EPI] <= SMEM_MAX;
}

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

// d[64 x 64] += A[64 x 16] B[64 x 16]^T, both K-major in shared memory.
// Thread (warp w, lane) holds d[4j + 2i + c] = D[16w + lane/4 + 8i,
// 8j + 2(lane%4) + c].
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// One 64-deep K block: four k16 steps, the descriptors advanced by 32 bytes
// inside the swizzled rows.
__device__ __forceinline__ void mma_block(float (&acc)[32], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int k = 0; k < BK / 16; ++k)
    wgmma_m64n64k16(acc, desc(a + 32 * k), desc(b + 32 * k));
}

// acc += sum over nk K blocks of A_kb B_kb^T.  load(kb, stage) issues this
// thread's cp.async copies of block kb into a ring stage: the A tile then
// the B tile when kStreamA, else the B tile alone, with A resident at
// a_addr(kb).  A STAGES-deep ring filled PREFETCH blocks ahead, with one
// wgmma group left in flight while the next block's copies are issued: the
// stage a load overwrites was read by the group two blocks back, which the
// wait of the previous iteration completed.  Every thread waits for its
// copies, fences them for the async proxy and meets the others before the
// wgmmas.
constexpr int PREFETCH = STAGES - 2;

template <bool kStreamA, class Load, class AAddr>
__device__ __forceinline__ void mainloop(float (&acc)[32], int nk,
                                         uint32_t ring, Load load,
                                         AAddr a_addr) {
  constexpr uint32_t STAGE = kStreamA ? 2 * TILE : TILE;
#pragma unroll
  for (int s = 0; s < PREFETCH; ++s) {
    if (s < nk) load(s, ring + s * STAGE);
    cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    cp_async_wait<PREFETCH - 1>();
    fence_proxy_async();
    __syncthreads();
    const int nxt = kb + PREFETCH;
    if (nxt < nk) load(nxt, ring + (nxt % STAGES) * STAGE);
    cp_async_commit();
    const uint32_t st = ring + (kb % STAGES) * STAGE;
    fence_acc(acc);
    wgmma_fence();
    mma_block(acc, kStreamA ? st : a_addr(kb), kStreamA ? st + TILE : st);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();
  __syncthreads();
}

// Eight f32 values rounded to bf16 and stored as one 16-byte chunk.
__device__ __forceinline__ void store_bf16x8(uint8_t* dst, const float (&v)[8]) {
  alignas(16) __nv_bfloat162 q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(q);
}

// Accumulator coordinates of this thread: row offset (add 8 for i = 1) and
// column offset inside an n8 block (add 1 for c = 1).
__device__ __forceinline__ int acc_row() {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int acc_col() { return 2 * (threadIdx.x & 3); }

// Gate: h = bf16(sigmoid(z[:C]) * tanh(z[C:])) for rows t0.. of sample b
// and channels n0 = 32 blockIdx.y ...; K = 3 taps x Cp.  BT, bd's dtype:
// bf16 (K1) or f32 (the training forward, diffnet_stack_train.cu).
template <typename BT>
__global__ void __launch_bounds__(THREADS)
gate_tc_kernel(const bf16* __restrict__ y, const bf16* __restrict__ wp,
               const BT* __restrict__ bd, const bf16* __restrict__ cond,
               bf16* __restrict__ h, int T, int C, int cp, int d) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = smem_u32(smem_raw) + align_pad(smem_raw);
  const int tid = threadIdx.x, t0 = blockIdx.x * BM, nt = blockIdx.y;
  const int b = blockIdx.z, kpt = cp / BK;
  const bf16* yb = y + (size_t)b * T * cp;
  const bf16* wt = wp + (size_t)nt * BN * 3 * cp;
  auto load = [&](int kb, uint32_t st) {
    const int tap = kb / kpt, c0 = (kb - tap * kpt) * BK;
    const int shift = (tap - 1) * d;
#pragma unroll
    for (int i = 0; i < BM * 8 / THREADS; ++i) {
      const int e = tid + i * THREADS, r = e >> 3, ch = e & 7;
      const int ts = t0 + r + shift;
      const bool ok = ts >= 0 && ts < T;
      cp_async16(st + swz(r, ch), ok ? yb + (size_t)ts * cp + c0 + ch * 8 : yb,
                 ok);
      cp_async16(st + TILE + swz(r, ch),
                 wt + (size_t)r * 3 * cp + tap * cp + c0 + ch * 8, true);
    }
  };
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  mainloop<true>(acc, 3 * kpt, ring, load, [](int) { return 0u; });

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
        bg[2 * j + e] = o < C ? to_f(bd[o]) : 0.f;
        bf[2 * j + e] = o < C ? to_f(bd[C + o]) : 0.f;
      }
      cg[4 * j + e] = ok ? to_f(cond[row * C2 + o]) : 0.f;
      cf[4 * j + e] = ok ? to_f(cond[row * C2 + C + o]) : 0.f;
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
      h[((size_t)b * T + t) * cp + o] =
          __float2bfloat16(dsvc::sigmoidf_(zg) * tanhf(zf));
    }
}

// This thread's cp.async copies of K block kb of an output projection into
// a ring stage: rows t0.. of one sample's h [T, Cp] (zero-filled past T),
// then this N tile's BN rows of the packed wo [2Cp, Cp] (K1's out_tc_kernel
// and K6's, diffnet_block.cu).
__device__ __forceinline__ void load_out_stage(const bf16* hb, const bf16* wt,
                                               int T, int t0, int cp, int kb,
                                               uint32_t st) {
  const int c0 = kb * BK;
#pragma unroll
  for (int i = 0; i < BM * 8 / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS, r = e >> 3, ch = e & 7;
    const bool ok = t0 + r < T;
    cp_async16(st + swz(r, ch),
               ok ? hb + (size_t)(t0 + r) * cp + c0 + ch * 8 : hb, ok);
    cp_async16(st + TILE + swz(r, ch), wt + (size_t)r * cp + c0 + ch * 8,
               true);
  }
}

// Output projection: o = h wo + bo; x <- XT((x + o[:C]) / sqrt 2) in place,
// skip (f32) = o[C:] (first layer) or skip + o[C:], and, unless y is null,
// the next layer's y = bf16(x + sb_next), from x in XT.  XT, the state's
// dtype, and BT, the biases': bf16 (K1), or f32 for the training forward,
// which also stores the layer's input bf16(x) into xsave (unless null).
template <typename XT, typename BT>
__global__ void __launch_bounds__(THREADS)
out_tc_kernel(const bf16* __restrict__ h, const bf16* __restrict__ wp,
              const BT* __restrict__ bo, XT* __restrict__ x,
              float* __restrict__ skip, bf16* __restrict__ y,
              const BT* __restrict__ sbn, long long sb_b,
              bf16* __restrict__ xsave, int T, int C, int cp, int first) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = smem_u32(smem_raw) + align_pad(smem_raw);
  const int t0 = blockIdx.x * BM, nt = blockIdx.y, b = blockIdx.z;
  const bf16* hb = h + (size_t)b * T * cp;
  const bf16* wt = wp + (size_t)nt * BN * cp;
  auto load = [&](int kb, uint32_t st) {
    load_out_stage(hb, wt, T, t0, cp, kb, st);
  };
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  mainloop<true>(acc, cp / BK, ring, load, [](int) { return 0u; });

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
        br[2 * j + e] = o < C ? to_f(bo[o]) : 0.f;
        bs[2 * j + e] = o < C ? to_f(bo[C + o]) : 0.f;
        sbv[2 * j + e] = o < C && y != nullptr ? to_f(sbn[b * sb_b + o]) : 0.f;
      }
      xv[4 * j + e] = ok ? to_f(x[idx]) : 0.f;
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
      const XT xn = dsvc::from_f<XT>((xv[4 * j + e] + res) * inv_sqrt2);
      if (xsave != nullptr) xsave[idx] = __float2bfloat16(xv[4 * j + e]);
      x[idx] = xn;
      skip[idx] = first ? sk : sv[4 * j + e] + sk;
      if (y != nullptr)
        y[row * cp + o] = __float2bfloat16(to_f(xn) + sbv[2 * j + (e & 1)]);
    }
}

// Layer 0's y = bf16(x + sb_0) into the [B, T, Cp] buffer.
template <typename XT, typename BT>
__global__ void y0_kernel(const XT* __restrict__ x,
                          const BT* __restrict__ sb0, long long sb_b,
                          bf16* __restrict__ y, int B, int T, int C, int cp) {
  const long long n = (long long)B * T * C;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / C;
    const int c = static_cast<int>(i - row * C);
    const long long b = row / T;
    y[row * cp + c] = __float2bfloat16(to_f(x[i]) + to_f(sb0[b * sb_b + c]));
  }
}

// Both layer kernels may use the plan's shared memory.
template <typename XT = bf16, typename BT = bf16>
inline int prepare_layers(const int* plan) {
  int e = allow_smem(gate_tc_kernel<BT>, plan[P_SMEM_LAYER]);
  if (e == 0) e = allow_smem(out_tc_kernel<XT, BT>, plan[P_SMEM_LAYER]);
  return e;
}

// The L layers in order on tensor cores: x [B,T,C] state (in place), y and
// h [B,T,Cp] scratch with zero pad channels (y holds layer 0's y already
// when y_ready), skip [B,T,C] f32 out; sb [L,B,C] with element strides
// (sb_l, sb_b); cond [L,B,T,2C]; wdp [L,2Cp,3Cp] and wop [L,2Cp,Cp] packed
// by the wrapper; bd, bo [L,2C]; xsave (unless null) [L,B,T,C] gets each
// layer's input in bf16.  prepare_layers<XT, BT>(plan) must have run.
template <typename XT, typename BT>
inline int run_stack_tc(XT* x, bf16* y, bf16* h, float* skip,
                        const BT* sb, long long sb_l, long long sb_b,
                        const bf16* cond, const bf16* wdp, const BT* bd,
                        const bf16* wop, const BT* bo, int B, int T, int C,
                        int L, int cycle, bool y_ready, const int* plan,
                        cudaStream_t s, bf16* xsave = nullptr) {
  const int cp = plan[P_CP], smem = plan[P_SMEM_LAYER];
  const dim3 grid(plan[P_GRID_M], plan[P_GRID_N_LAYER], B);
  const long long rows = (long long)B * T, C2 = 2LL * C;
  if (!y_ready) {
    const long long need = (rows * C + 255) / 256;
    const int blocks = static_cast<int>(need < 4096 ? need : 4096);
    y0_kernel<<<blocks, 256, 0, s>>>(x, sb, sb_b, y, B, T, C, cp);
    DSVC_LAUNCH_CHECK();
  }
  for (int l = 0; l < L; ++l) {
    const int d = 1 << (l % cycle);
    gate_tc_kernel<BT><<<grid, THREADS, smem, s>>>(
        y, wdp + (size_t)l * 2 * cp * 3 * cp, bd + l * C2,
        cond + l * rows * C2, h, T, C, cp, d);
    DSVC_LAUNCH_CHECK();
    const bool last = l + 1 == L;
    out_tc_kernel<XT, BT><<<grid, THREADS, smem, s>>>(
        h, wop + (size_t)l * 2 * cp * cp, bo + l * C2, x, skip,
        last ? nullptr : y, last ? sb : sb + (l + 1) * sb_l, sb_b,
        xsave == nullptr ? nullptr : xsave + l * rows * C, T, C, cp, l == 0);
    DSVC_LAUNCH_CHECK();
  }
  return 0;
}

}  // namespace tc
}  // namespace
