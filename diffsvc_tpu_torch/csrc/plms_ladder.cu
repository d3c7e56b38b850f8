// Sampling ladder (K2) for Hopper: the whole trajectory of J denoiser
// evaluations, PLMS or DPM-Solver++(2M), in one C call.
//
// Replaces diffsvc_tpu/ops/pallas/plms_ladder.py:plms_ladder (kernel
// _ladder_kernel).  On the TPU the whole ladder is one kernel with the
// [T, C] state resident in VMEM; at production T that state (1024 x 384
// bf16 = 768 KB) does not fit one SM's 227 KB of shared memory, so here a
// host loop over the J evaluations (dsvc_plms_ladder, below: no Python per
// evaluation) launches, per evaluation:
//   input projection  act = relu(x_eval W_in + b_in)           (this file)
//   K1's layers on act with step-bias row j
//                                 (diffnet_layer_tc.cuh, _tf32x3.cuh)
//   epilogue          eps = relu(skip/sqrt(L) W_skip + b) W_out + b_out,
//                     then g = clip(p x_eval + q eps); f = e0 x_eval + e1 g;
//                     n = w0 f + w1 h0 + w2 h1 + w3 h2; x_next = u x + v n;
//                     x_eval <- x_next; x <- sel ? x_next : x;
//                     (h0,h1,h2) <- push ? (f,h0,h1) : (h0,h1,h2)  (this file)
// The per-evaluation scalars are read from a [J, 12] f32 device table, so
// the loop never syncs with the host; the wrapper allocates one workspace
// per ladder (state, history, K1's x, y, h and skip).  Sampler state stays
// f32.
//
// What bounds it on the H100: K1's tensor-core operations (48.3 GFLOP per
// evaluation at T=1024, C=384, L=20); this file's two projections add ~0.5
// GFLOP.  Both dtypes run both on wgmma, as K1 does, and apply the update
// in f32.  bf16 (the TPU kernel's only dtype): the input projection stages
// x_eval rounded to bf16 and writes K1's x_0 and layer 0's y_0 from its
// epilogue; the epilogue kernel keeps a 64-row tile of sk and then of s1
// resident in shared memory (swizzled for wgmma) while the weight tiles
// stream through a cp.async ring.  f32 (no TPU counterpart; the default
// config's dtype) as 3xTF32 split products (diffnet_layer_tf32x3.cuh): the
// input projection splits x_eval into hi and lo tiles as it stages them;
// the epilogue is two kernels, because a resident hi/lo tile pair of sk and
// of s1 (4 x 96 KB at C=384) does not fit an SM: K1's last output kernel
// writes sk = skip / sqrt(L) split into y's planes, the skip projection
// reads them through the layers' ring and writes s1 split into h's planes
// (both stay in L2), and the output projection reads those and applies
// the update.
#include "diffnet_layer_tf32x3.cuh"

namespace {

namespace tc {

// Input projection for rows t0.. of sample b and columns 64 blockIdx.y..:
// act = bf16(relu(bf16(x_eval) W_in + b_in)) into K1's state xs [B,T,C] and
// y_0 = bf16(act + sb_0) into y [B,T,Cp].  x_eval [B,T,M] f32 is rounded
// while it is staged; winp [Cp, Mp] is W_in packed K-major.  A and B stay
// resident (Mp/64 tiles each).
__global__ void __launch_bounds__(THREADS)
in_proj_tc_kernel(const float* __restrict__ xe, const bf16* __restrict__ winp,
                  const bf16* __restrict__ bin, bf16* __restrict__ xs,
                  bf16* __restrict__ y, const bf16* __restrict__ sb0,
                  long long sb_b, int T, int M, int mp, int C, int cp) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = align_pad(smem_raw);
  uint8_t* sm = smem_raw + pad;
  const uint32_t base = smem_u32(smem_raw) + pad;
  const int tid = threadIdx.x, t0 = blockIdx.x * BM, nt = blockIdx.y;
  const int b = blockIdx.z, kbs = mp / BK;
  const uint32_t bs = base + kbs * TILE;   // B tiles after the A tiles
  for (int kb = 0; kb < kbs; ++kb)
#pragma unroll
    for (int i = 0; i < BM * 8 / THREADS; ++i) {
      const int e = tid + i * THREADS, r = e >> 3, ch = e & 7;
      cp_async16(bs + kb * TILE + swz(r, ch),
                 winp + (size_t)(nt * BN + r) * mp + kb * BK + ch * 8, true);
    }
  cp_async_commit();
  for (int kb = 0; kb < kbs; ++kb)
#pragma unroll
    for (int i = 0; i < BM * 8 / THREADS; ++i) {
      const int e = tid + i * THREADS, r = e >> 3, ch = e & 7;
      const int t = t0 + r, k0 = kb * BK + ch * 8;
      const float* src = xe + ((size_t)b * T + t) * M + k0;
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        v[q] = (t < T && k0 + q < M) ? src[q] : 0.f;
      store_bf16x8(sm + kb * TILE + swz(r, ch), v);
    }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_acc(acc);
  wgmma_fence();
  for (int kb = 0; kb < kbs; ++kb)
    mma_block(acc, base + kb * TILE, bs + kb * TILE);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);

  // the epilogue's loads first, all in flight together, then the math
  const int r0 = acc_row(), cq = acc_col();
  float bi[16], sbv[16];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int o = nt * BN + 8 * (n >> 1) + cq + (n & 1);
    bi[n] = o < C ? to_f(bin[o]) : 0.f;
    sbv[n] = o < C ? to_f(sb0[b * sb_b + o]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + r0 + 8 * (e >> 1), o = nt * BN + 8 * j + cq + (e & 1);
      if (t >= T || o >= C) continue;
      const size_t row = (size_t)b * T + t;
      const bf16 a = __float2bfloat16(
          fmaxf(acc[4 * j + e] + bi[2 * j + (e & 1)], 0.f));
      xs[row * C + o] = a;
      y[row * cp + o] =
          __float2bfloat16(__bfloat162float(a) + sbv[2 * j + (e & 1)]);
    }
}

// Epilogue for rows t0.. of sample b: sk = bf16(skip / sqrt L) (resident),
// s1 = bf16(relu(sk W_skip + b_skip)) (resident, 64 columns at a time),
// eps = s1 W_out + b_out (64 columns at a time), then the 12-scalar update
// of x, x_eval and the history [3, B, T, M] in f32.  wskp [Cp, Cp] and
// woutp [Mp, Cp] are packed K-major; their tiles stream through the ring.
__global__ void __launch_bounds__(THREADS)
epilogue_tc_kernel(const float* __restrict__ skip,
                   const bf16* __restrict__ wskp,
                   const bf16* __restrict__ bskip,
                   const bf16* __restrict__ woutp,
                   const bf16* __restrict__ bout, const float* __restrict__ sc,
                   float* __restrict__ x, float* __restrict__ xe,
                   float* __restrict__ hist, int B, int T, int C, int cp,
                   int M, int mp, int L, float clip_v) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = align_pad(smem_raw);
  uint8_t* sm = smem_raw + pad;
  const uint32_t base = smem_u32(smem_raw) + pad;
  const int tid = threadIdx.x, t0 = blockIdx.x * BM, b = blockIdx.z;
  const int kbs = cp / BK;
  uint8_t* s1 = sm + kbs * TILE;                 // after the sk tiles
  const uint32_t ring = base + 2 * kbs * TILE;   // after the s1 tiles
  const float inv_sqrt_l = (float)(1.0 / sqrt((double)L));
  for (int kb = 0; kb < kbs; ++kb)
#pragma unroll
    for (int i = 0; i < BM * 8 / THREADS; ++i) {
      const int e = tid + i * THREADS, r = e >> 3, ch = e & 7;
      const int t = t0 + r, c0 = kb * BK + ch * 8;
      const float* src = skip + ((size_t)b * T + t) * C + c0;
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        v[q] = (t < T && c0 + q < C) ? src[q] * inv_sqrt_l : 0.f;
      store_bf16x8(sm + kb * TILE + swz(r, ch), v);
    }
  const int r0 = acc_row(), cq = acc_col();
  float acc[32];
  for (int nc = 0; nc < kbs; ++nc) {
    auto load = [&](int kb, uint32_t st) {
#pragma unroll
      for (int i = 0; i < BM * 8 / THREADS; ++i) {
        const int e = tid + i * THREADS, r = e >> 3, ch = e & 7;
        cp_async16(st + swz(r, ch),
                   wskp + (size_t)(nc * BN + r) * cp + kb * BK + ch * 8, true);
      }
    };
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    mainloop<false>(acc, kbs, ring, load,
                    [&](int kb) { return base + kb * TILE; });
    // s1 columns nc*64.. : tile nc, chunk j, element cq + (e & 1)
    float bsk[16];
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int o = nc * BN + 8 * (n >> 1) + cq + (n & 1);
      bsk[n] = o < C ? to_f(bskip[o]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 8 * (e >> 1), o = nc * BN + 8 * j + cq + (e & 1);
        const float v =
            o < C ? fmaxf(acc[4 * j + e] + bsk[2 * j + (e & 1)], 0.f) : 0.f;
        *reinterpret_cast<bf16*>(s1 + nc * TILE + swz(r, j) +
                                 2 * (cq + (e & 1))) = __float2bfloat16(v);
      }
  }
  const float p = sc[0], q = sc[1], e0 = sc[2], e1 = sc[3];
  const float w0 = sc[4], w1 = sc[5], w2 = sc[6], w3 = sc[7];
  const float u = sc[8], v = sc[9], sel = sc[10], push = sc[11];
  const size_t plane = (size_t)B * T * M;
  for (int mc = 0; mc < mp / BK; ++mc) {
    auto load = [&](int kb, uint32_t st) {
#pragma unroll
      for (int i = 0; i < BM * 8 / THREADS; ++i) {
        const int e = tid + i * THREADS, r = e >> 3, ch = e & 7;
        cp_async16(st + swz(r, ch),
                   woutp + (size_t)(mc * BN + r) * cp + kb * BK + ch * 8,
                   true);
      }
    };
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    mainloop<false>(acc, kbs, ring, load,
                    [&](int kb) { return base + (kbs + kb) * TILE; });
    // per n8 block: the state's loads first, all in flight, then the update
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float st[4][5];   // xe, h0, h1, h2, x
      float bo[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int m = mc * BN + 8 * j + cq + c;
        bo[c] = m < M ? to_f(bout[m]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + r0 + 8 * (e >> 1);
        const int m = mc * BN + 8 * j + cq + (e & 1);
        const bool ok = t < T && m < M;
        const size_t i = ((size_t)b * T + t) * M + m;
        st[e][0] = ok ? xe[i] : 0.f;
        st[e][1] = ok ? hist[i] : 0.f;
        st[e][2] = ok ? hist[plane + i] : 0.f;
        st[e][3] = ok ? hist[2 * plane + i] : 0.f;
        st[e][4] = ok ? x[i] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + r0 + 8 * (e >> 1);
        const int m = mc * BN + 8 * j + cq + (e & 1);
        if (t >= T || m >= M) continue;
        const size_t i = ((size_t)b * T + t) * M + m;
        const float eps = acc[4 * j + e] + bo[e & 1];
        const float xev = st[e][0];
        float g = p * xev + q * eps;
        if (clip_v > 0.f) g = fminf(fmaxf(g, -clip_v), clip_v);
        const float f = e0 * xev + e1 * g;
        const float h0 = st[e][1], h1 = st[e][2], h2 = st[e][3];
        const float n = w0 * f + w1 * h0 + w2 * h1 + w3 * h2;
        const float xc = st[e][4];
        const float xn = u * xc + v * n;
        xe[i] = xn;
        x[i] = xc + sel * (xn - xc);
        hist[2 * plane + i] = h2 + push * (h1 - h2);
        hist[plane + i] = h1 + push * (h0 - h1);
        hist[i] = h0 + push * (f - h0);
      }
    }
  }
}

}  // namespace tc

namespace tf32x3 {

// Input projection at 3xTF32 for rows t0.. of sample b and columns 64
// blockIdx.y..: act = relu(x_eval W_in + b_in) into K1's state xs [B,T,C]
// and y_0 = act + sb_0 into y's hi and lo planes [2,B,T,Cp].  x_eval
// [B,T,M] is split into hi and lo tiles while it is staged; winp [2,Cp,Mp]
// is W_in packed K-major and split.  A and B stay resident (Mp/32 tiles
// each, per plane).
__global__ void __launch_bounds__(THREADS)
in_proj_kernel(const float* __restrict__ xe, const float* __restrict__ winp,
               const float* __restrict__ bin, float* __restrict__ xs,
               float* __restrict__ y, const float* __restrict__ sb0, int B,
               int T, int M, int mp, int C, int cp) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = align_pad(smem_raw);
  uint8_t* sm = smem_raw + pad;
  const uint32_t base = smem_u32(smem_raw) + pad;
  const int tid = threadIdx.x, t0 = blockIdx.x * BM, nt = blockIdx.y;
  const int b = blockIdx.z, kbs = mp / BK;
  // tiles: A hi [kbs], A lo [kbs], then B hi [kbs], B lo [kbs]
  const uint32_t bs = base + 2 * kbs * TILE;
  const size_t wplane = (size_t)cp * mp;
  for (int kb = 0; kb < kbs; ++kb)
#pragma unroll
    for (int i = 0; i < BM * 8 / THREADS; ++i) {
      const int e = tid + i * THREADS, r = e >> 3, ch = e & 7;
      const float* w = winp + (size_t)(nt * BN + r) * mp + kb * BK + ch * 4;
      cp_async16(bs + kb * TILE + swz(r, ch), w, true);
      cp_async16(bs + (kbs + kb) * TILE + swz(r, ch), w + wplane, true);
    }
  cp_async_commit();
  for (int kb = 0; kb < kbs; ++kb)
#pragma unroll
    for (int i = 0; i < BM * 8 / THREADS; ++i) {
      const int e = tid + i * THREADS, r = e >> 3, ch = e & 7;
      const int t = t0 + r, k0 = kb * BK + ch * 4;
      const float* src = xe + ((size_t)b * T + t) * M + k0;
      alignas(16) float hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = (t < T && k0 + q < M) ? src[q] : 0.f;
        hi[q] = tf32_rna(v);
        lo[q] = tf32_rna(v - hi[q]);
      }
      *reinterpret_cast<float4*>(sm + kb * TILE + swz(r, ch)) =
          *reinterpret_cast<const float4*>(hi);
      *reinterpret_cast<float4*>(sm + (kbs + kb) * TILE + swz(r, ch)) =
          *reinterpret_cast<const float4*>(lo);
    }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  float acc[32], blk[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = blk[i] = 0.f;
  for (int kb = 0; kb < kbs; ++kb) {
    fence_acc(blk);
    wgmma_fence();
    mma_block(blk, base + kb * TILE, base + (kbs + kb) * TILE,
              bs + kb * TILE, bs + (kbs + kb) * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(blk);
    add_block(acc, blk);
  }

  // the epilogue's loads first, all in flight together, then the math
  const int r0 = acc_row(), cq = acc_col();
  const size_t plane = (size_t)B * T * cp;
  float bi[16], sbv[16];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int o = nt * BN + 8 * (n >> 1) + cq + (n & 1);
    bi[n] = o < C ? bin[o] : 0.f;
    sbv[n] = o < C ? sb0[o] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + r0 + 8 * (e >> 1), o = nt * BN + 8 * j + cq + (e & 1);
      if (t >= T || o >= C) continue;
      const size_t row = (size_t)b * T + t;
      const float a = fmaxf(acc[4 * j + e] + bi[2 * j + (e & 1)], 0.f);
      xs[row * C + o] = a;
      store_split(y, row * cp + o, plane, a + sbv[2 * j + (e & 1)]);
    }
}

// Skip projection at 3xTF32 for rows t0.. of sample b and columns 64
// blockIdx.y..: s1 = relu(sk W_skip + b_skip), sk read from the hi and lo
// planes of y [2,B,T,Cp] (K1's last output kernel wrote them), s1 written
// split into h's planes [2,B,T,Cp] (pad channels stay zero).  wskp
// [2,Cp,Cp] is W_skip packed K-major and split.
__global__ void __launch_bounds__(THREADS)
skip_proj_kernel(const float* __restrict__ y, const float* __restrict__ wskp,
                 const float* __restrict__ bskip, float* __restrict__ h,
                 int B, int T, int C, int cp) {
  extern __shared__ uint8_t smem_raw[];
  const int t0 = blockIdx.x * BM, nt = blockIdx.y, b = blockIdx.z;
  const size_t plane = (size_t)B * T * cp;
  const Operands op{y + (size_t)b * T * cp, plane,
                    wskp + (size_t)nt * BN * cp, (size_t)cp * cp,
                    T, t0, cp, 1, 0};
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  mainloop(acc, op, ring_base(smem_raw));
  const int r0 = acc_row(), cq = acc_col();
  float bsk[16];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int o = nt * BN + 8 * (n >> 1) + cq + (n & 1);
    bsk[n] = o < C ? bskip[o] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + r0 + 8 * (e >> 1), o = nt * BN + 8 * j + cq + (e & 1);
      if (t >= T || o >= C) continue;
      store_split(h, ((size_t)b * T + t) * cp + o, plane,
                  fmaxf(acc[4 * j + e] + bsk[2 * j + (e & 1)], 0.f));
    }
}

// Output projection and update at 3xTF32 for rows t0.. of sample b and mel
// bins 64 blockIdx.y..: eps = s1 W_out + b_out, s1 read from h's planes,
// then the 12-scalar update of x, x_eval and the history [3,B,T,M] in f32,
// as the bf16 epilogue applies it.  woutp [2,Mp,Cp] is W_out packed
// K-major and split.
__global__ void __launch_bounds__(THREADS)
out_proj_kernel(const float* __restrict__ h, const float* __restrict__ woutp,
                const float* __restrict__ bout, const float* __restrict__ sc,
                float* __restrict__ x, float* __restrict__ xe,
                float* __restrict__ hist, int B, int T, int cp, int M, int mp,
                float clip_v) {
  extern __shared__ uint8_t smem_raw[];
  const int t0 = blockIdx.x * BM, mc = blockIdx.y, b = blockIdx.z;
  const Operands op{h + (size_t)b * T * cp, (size_t)B * T * cp,
                    woutp + (size_t)mc * BN * cp, (size_t)mp * cp,
                    T, t0, cp, 1, 0};
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  mainloop(acc, op, ring_base(smem_raw));
  const int r0 = acc_row(), cq = acc_col();
  const float p = sc[0], q = sc[1], e0 = sc[2], e1 = sc[3];
  const float w0 = sc[4], w1 = sc[5], w2 = sc[6], w3 = sc[7];
  const float u = sc[8], v = sc[9], sel = sc[10], push = sc[11];
  const size_t plane = (size_t)B * T * M;
  // per n8 block: the state's loads first, all in flight, then the update
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float st[4][5];   // xe, h0, h1, h2, x
    float bo[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int m = mc * BN + 8 * j + cq + c;
      bo[c] = m < M ? bout[m] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + r0 + 8 * (e >> 1);
      const int m = mc * BN + 8 * j + cq + (e & 1);
      const bool ok = t < T && m < M;
      const size_t i = ((size_t)b * T + t) * M + m;
      st[e][0] = ok ? xe[i] : 0.f;
      st[e][1] = ok ? hist[i] : 0.f;
      st[e][2] = ok ? hist[plane + i] : 0.f;
      st[e][3] = ok ? hist[2 * plane + i] : 0.f;
      st[e][4] = ok ? x[i] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + r0 + 8 * (e >> 1);
      const int m = mc * BN + 8 * j + cq + (e & 1);
      if (t >= T || m >= M) continue;
      const size_t i = ((size_t)b * T + t) * M + m;
      const float eps = acc[4 * j + e] + bo[e & 1];
      const float xev = st[e][0];
      float g = p * xev + q * eps;
      if (clip_v > 0.f) g = fminf(fmaxf(g, -clip_v), clip_v);
      const float f = e0 * xev + e1 * g;
      const float h0 = st[e][1], h1 = st[e][2], h2 = st[e][3];
      const float n = w0 * f + w1 * h0 + w2 * h1 + w3 * h2;
      const float xc = st[e][4];
      const float xn = u * xc + v * n;
      xe[i] = xn;
      x[i] = xc + sel * (xn - xc);
      hist[2 * plane + i] = h2 + push * (h1 - h2);
      hist[plane + i] = h1 + push * (h0 - h1);
      hist[i] = h0 + push * (f - h0);
    }
  }
}

}  // namespace tf32x3
}  // namespace

extern "C" {

// The whole ladder.  Workspace: x, xe [B,T,M] and hist [3,B,T,M] f32
// sampler state (x = xe = x_init and hist = 0 on entry; x is the result),
// xs [B,T,C] K1's state, skip [B,T,C] f32; y and h [B,T,Cp] (bf16) or
// [2,B,T,Cp] hi and lo planes (f32) with zero pad channels.  scal [J,12]
// f32, sb_tab [J,L,C], cond [L,B,T,2C], bd and bo [L,2C], bin [C], bskip
// [C], bout [M] in the compute dtype; win, wskip and wout packed K-major
// ([Cp,Mp], [Cp,Cp], [Mp,Cp]), wd and wo packed as for K1, each split into
// a hi and a lo plane at f32 ([2,...]); plan the wrapper's launch plan.
int dsvc_plms_ladder(int dtype, void* x, void* xe, void* hist, void* xs,
                     void* y, void* h, void* skip, const void* scal,
                     const void* sb_tab, const void* cond, const void* win,
                     const void* bin, const void* wskip, const void* bskip,
                     const void* wout, const void* bout, const void* wd,
                     const void* bd, const void* wo, const void* bo, int J,
                     int B, int T, int C, int M, int L, int cycle,
                     float clip_v, const int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scal);
  if (dtype == DSVC_BF16) {
    using tc::bf16;
    if (!tc::plan_ok(plan, T, C, M)) return cudaErrorInvalidValue;
    const int cp = plan[tc::P_CP], mp = plan[tc::P_MP];
    const int smem_in = plan[tc::P_SMEM_IN], smem_epi = plan[tc::P_SMEM_EPI];
    int e = tc::prepare_layers(plan);
    if (e == 0) e = tc::allow_smem(tc::in_proj_tc_kernel, smem_in);
    if (e == 0) e = tc::allow_smem(tc::epilogue_tc_kernel, smem_epi);
    if (e != 0) return e;
    const dim3 grid_in(plan[tc::P_GRID_M], plan[tc::P_GRID_N_IN], B);
    const dim3 grid_epi(plan[tc::P_GRID_M], 1, B);
    const bf16* sbt = static_cast<const bf16*>(sb_tab);
    for (int j = 0; j < J; ++j) {
      const bf16* sb = sbt + (size_t)j * L * C;
      tc::in_proj_tc_kernel<<<grid_in, tc::THREADS, smem_in, s>>>(
          static_cast<const float*>(xe), static_cast<const bf16*>(win),
          static_cast<const bf16*>(bin), static_cast<bf16*>(xs),
          static_cast<bf16*>(y), sb, 0, T, M, mp, C, cp);
      DSVC_LAUNCH_CHECK();
      e = tc::run_stack_tc(
          static_cast<bf16*>(xs), static_cast<bf16*>(y), static_cast<bf16*>(h),
          static_cast<float*>(skip), sb, C, 0, static_cast<const bf16*>(cond),
          static_cast<const bf16*>(wd), static_cast<const bf16*>(bd),
          static_cast<const bf16*>(wo), static_cast<const bf16*>(bo), B, T, C,
          L, cycle, true, plan, s);
      if (e != 0) return e;
      tc::epilogue_tc_kernel<<<grid_epi, tc::THREADS, smem_epi, s>>>(
          static_cast<const float*>(skip), static_cast<const bf16*>(wskip),
          static_cast<const bf16*>(bskip), static_cast<const bf16*>(wout),
          static_cast<const bf16*>(bout), sc + (size_t)j * 12,
          static_cast<float*>(x), static_cast<float*>(xe),
          static_cast<float*>(hist), B, T, C, cp, M, mp, L, clip_v);
      DSVC_LAUNCH_CHECK();
    }
    return 0;
  }
  namespace x3 = tf32x3;
  if (!x3::plan_ok(plan, T, C, M)) return cudaErrorInvalidValue;
  const int cp = plan[tc::P_CP], mp = plan[tc::P_MP];
  const int smem_in = plan[tc::P_SMEM_IN], smem_epi = plan[tc::P_SMEM_EPI];
  int e = x3::prepare_layers(plan);
  if (e == 0) e = tc::allow_smem(x3::in_proj_kernel, smem_in);
  if (e == 0) e = tc::allow_smem(x3::skip_proj_kernel, smem_epi);
  if (e == 0) e = tc::allow_smem(x3::out_proj_kernel, smem_epi);
  if (e != 0) return e;
  const dim3 grid_in(plan[tc::P_GRID_M], plan[tc::P_GRID_N_IN], B);
  const dim3 grid_out(plan[tc::P_GRID_M], mp / x3::BN, B);
  const float inv_sqrt_l = (float)(1.0 / sqrt((double)L));
  const float* sbt = static_cast<const float*>(sb_tab);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h);
  for (int j = 0; j < J; ++j) {
    const float* sb = sbt + (size_t)j * L * C;
    x3::in_proj_kernel<<<grid_in, x3::THREADS, smem_in, s>>>(
        static_cast<const float*>(xe), static_cast<const float*>(win),
        static_cast<const float*>(bin), static_cast<float*>(xs), yf, sb, B,
        T, M, mp, C, cp);
    DSVC_LAUNCH_CHECK();
    e = x3::run_stack(static_cast<float*>(xs), yf, hf,
                      static_cast<float*>(skip), sb, C, 0,
                      static_cast<const float*>(cond),
                      static_cast<const float*>(wd),
                      static_cast<const float*>(bd),
                      static_cast<const float*>(wo),
                      static_cast<const float*>(bo), B, T, C, L, cycle, true,
                      inv_sqrt_l, plan, s);
    if (e != 0) return e;
    x3::skip_proj_kernel<<<grid_in, x3::THREADS, smem_epi, s>>>(
        yf, static_cast<const float*>(wskip),
        static_cast<const float*>(bskip), hf, B, T, C, cp);
    DSVC_LAUNCH_CHECK();
    x3::out_proj_kernel<<<grid_out, x3::THREADS, smem_epi, s>>>(
        hf, static_cast<const float*>(wout), static_cast<const float*>(bout),
        sc + (size_t)j * 12, static_cast<float*>(x), static_cast<float*>(xe),
        static_cast<float*>(hist), B, T, cp, M, mp, clip_v);
    DSVC_LAUNCH_CHECK();
  }
  return 0;
}

}  // extern "C"
