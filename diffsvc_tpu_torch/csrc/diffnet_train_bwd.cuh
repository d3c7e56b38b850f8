// The DiffNet residual stack's training backward, shared by the batch-fused
// backward (K4, diffnet_stack_train.cu) and the per-sample backward (K5,
// diffnet_stack_per_sample.cu).  The layers run in reverse; per layer l,
// with d = 2^(l mod cycle):
//   1. gate_kernel recomputes z = conv(y) + bd + cond from the saved, rounded
//      x_l (f32 z into scratch) and h = rnd(sigmoid(z_g) tanh(z_f));
//   2. make_do:   do = [dx / sqrt2 | dout]                    (f32 scratch)
//   3. dh_kernel: dh = rnd(do) wo^T; dz = [dh s(1-s)tf | dh s(1-tf^2)]
//      (f32, in place of z) and dcp_l = dz stored in DT;
//   4. dy_kernel: dy = sum_j shiftback_j(rnd(dcp_l)) W_j^T;
//      dx <- dy + dx / sqrt2;
//   5. weight grads dWo = h^T rnd(do), dW_j = y_shift(j)^T rnd(dcp_l): the
//      rows are cut into segments (K4: one segment of all B*T rows; K5: one
//      segment per sample), each segment into chunks of at most rch rows
//      that start at the segment's first row; each chunk's block writes its
//      own partial, then one kernel sums, for every element, the chunks of
//      each segment in order and the segments' sums in order;
//   6. dbo = sum do, dbd = sum dz (per segment, then over the segments in
//      order), dsb[b] = sum_t dy[b]: two-pass column sums.
// No atomics anywhere: every output element is written by one thread, and
// every reduction sums in a fixed order, so two runs give the same bits, and
// K5 at batch B gives exactly the in-order sum of its B = 1 runs.
//
// Types: OT the operands' dtype (xsave, cond, wd, wo, h; every product's
// operands are rounded to it), DT the dtype dcp is stored in (K4: OT; K5:
// f32, unrounded), GT the skip cotangent's dtype (K4: OT; K5: f32).  What
// bounds it on the H100: FLOPs on the CUDA cores, 44 C^2 FLOPs per row and
// layer (the recomputed gate GEMM, dh, dy, dWo, dW_j); tensor-core tiles
// are later work.
#pragma once

#include "diffnet_layer.cuh"

namespace {

constexpr float kInvSqrt2 = 0.7071067811865476f;

// acc[i][j] += sum_{k in [k_begin, k_end)} A(m0 + 4 ty + i, k) B(k, n0 + 2 tx + j)
// la(m, k) / lb(k, n) return the f32 operand, 0 outside the matrix.
// A_M_FAST / B_N_FAST name the index that is contiguous in memory, so that
// neighbouring threads load neighbouring addresses.
template <bool A_M_FAST, bool B_N_FAST, class LA, class LB>
__device__ __forceinline__ void tile_gemm(const LA& la, const LB& lb,
                                          int k_begin, int k_end, int m0,
                                          int n0, float (&acc)[4][2]) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int m = A_M_FAST ? e % BM : e / BK;
      const int kk = A_M_FAST ? e / BM : e % BK;
      const int k = k0 + kk;
      As[kk][m] = k < k_end ? la(m0 + m, k) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int n = B_N_FAST ? e % BN : e / BK;
      const int kk = B_N_FAST ? e / BN : e % BK;
      const int k = k0 + kk;
      Bs[kk][n] = k < k_end ? lb(k, n0 + n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 2; ++j) b[j] = Bs[kk][tx * 2 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// do [rows, 2C] = [dx / sqrt2 | dout]
template <typename GT>
__global__ void make_do_kernel(const float* __restrict__ dx,
                               const GT* __restrict__ dout,
                               float* __restrict__ do_, long long rows, int C) {
  const long long n = rows * 2 * C;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / (2 * C);
    const int c = static_cast<int>(i - r * 2 * C);
    do_[i] = c < C ? dx[r * C + c] * kInvSqrt2 : to_f(dout[r * C + c - C]);
  }
}

// dh = rnd(do) wo_l^T (K = 2C); epilogue: z -> dz in place, dcp_l = dz in DT
template <typename OT, typename DT>
__global__ void __launch_bounds__(NT)
dh_kernel(const float* __restrict__ do_, const OT* __restrict__ wo,
          float* __restrict__ z, DT* __restrict__ dcp, int rows, int C) {
  const int C2 = 2 * C;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  auto la = [&](int r, int k) {
    return r < rows ? rnd<OT>(do_[(long long)r * C2 + k]) : 0.f;
  };
  auto lb = [&](int k, int c) {
    return c < C ? to_f(wo[(long long)c * C2 + k]) : 0.f;
  };
  float acc[4][2] = {};
  tile_gemm<false, false>(la, lb, 0, C2, m0, n0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = n0 + tx * 2 + j;
      if (c >= C) continue;
      const long long ig = (long long)r * C2 + c, ifl = ig + C;
      const float dh = acc[i][j];
      const float s = dsvc::sigmoidf_(z[ig]);
      const float tf = tanhf(z[ifl]);
      const float dg = dh * s * (1.f - s) * tf;
      const float df = dh * s * (1.f - tf * tf);
      z[ig] = dg;
      z[ifl] = df;
      dcp[ig] = from_f<DT>(dg);
      dcp[ifl] = from_f<DT>(df);
    }
  }
}

// dy[t] = dz[t+d] W0^T + dz[t] W1^T + dz[t-d] W2^T (K = 6C, dz = rnd(dcp),
// zeros outside the sample); epilogue: dy out, dx <- dy + dx / sqrt2
template <typename OT, typename DT>
__global__ void __launch_bounds__(NT)
dy_kernel(const DT* __restrict__ dcp, const OT* __restrict__ wd,
          float* __restrict__ dy, float* __restrict__ dx, int B, int T_,
          int C, int d) {
  const int C2 = 2 * C, rows = B * T_;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  auto la = [&](int r, int k) {
    if (r >= rows) return 0.f;
    const int j = k / C2, n = k - j * C2;
    const int b = r / T_, t = r - b * T_, ts = t - (j - 1) * d;
    if (ts < 0 || ts >= T_) return 0.f;
    return rnd<OT>(to_f(dcp[((long long)b * T_ + ts) * C2 + n]));
  };
  auto lb = [&](int k, int c) {
    if (c >= C) return 0.f;
    const int j = k / C2, n = k - j * C2;
    return to_f(wd[((long long)j * C + c) * C2 + n]);
  };
  float acc[4][2] = {};
  tile_gemm<false, false>(la, lb, 0, 3 * C2, m0, n0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = n0 + tx * 2 + j;
      if (c >= C) continue;
      const long long idx = (long long)r * C + c;
      dy[idx] = acc[i][j];
      dx[idx] = acc[i][j] + dx[idx] * kInvSqrt2;
    }
  }
}

// The rows [r0, r1) of weight-grad chunk `chunk`: segments of seg_rows rows,
// cps chunks of at most rch rows each.
__device__ __forceinline__ void chunk_rows(int chunk, int seg_rows, int cps,
                                           int rch, int& r0, int& r1) {
  const int seg = chunk / cps, k = chunk - seg * cps;
  r0 = seg * seg_rows + k * rch;
  r1 = min((seg + 1) * seg_rows, r0 + rch);
}

// partial dWo over chunk blockIdx.z: part[z][k][n] = sum_r h[r,k] rnd(do[r,n])
template <typename OT>
__global__ void __launch_bounds__(NT)
wgrad_out_kernel(const OT* __restrict__ h, const float* __restrict__ do_,
                 float* __restrict__ part, int C, int seg_rows, int cps,
                 int rch) {
  const int C2 = 2 * C;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  int r0, r1;
  chunk_rows(blockIdx.z, seg_rows, cps, rch, r0, r1);
  auto la = [&](int m, int r) {
    return m < C ? to_f(h[(long long)r * C + m]) : 0.f;
  };
  auto lb = [&](int r, int n) {
    return n < C2 ? rnd<OT>(do_[(long long)r * C2 + n]) : 0.f;
  };
  float acc[4][2] = {};
  tile_gemm<true, true>(la, lb, r0, r1, m0, n0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* out = part + (long long)blockIdx.z * C * C2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= C) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + tx * 2 + j;
      if (n < C2) out[(long long)m * C2 + n] = acc[i][j];
    }
  }
}

// partial dW over chunk blockIdx.z:
// part[z][j*C + c][n] = sum_r y[r + (j-1) d, c] rnd(dcp[r, n]),
// y = rnd(x_l + sb)
template <typename OT, typename DT>
__global__ void __launch_bounds__(NT)
wgrad_dil_kernel(const OT* __restrict__ xs, const float* __restrict__ sb,
                 const DT* __restrict__ dcp, float* __restrict__ part, int T_,
                 int C, int d, int seg_rows, int cps, int rch) {
  const int C2 = 2 * C, M = 3 * C;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  int r0, r1;
  chunk_rows(blockIdx.z, seg_rows, cps, rch, r0, r1);
  auto la = [&](int m, int r) {
    if (m >= M) return 0.f;
    const int j = m / C, c = m - j * C;
    const int b = r / T_, t = r - b * T_, ts = t + (j - 1) * d;
    if (ts < 0 || ts >= T_) return 0.f;
    return rnd<OT>(to_f(xs[((long long)b * T_ + ts) * C + c]) +
                   sb[(long long)b * C + c]);
  };
  auto lb = [&](int r, int n) {
    return n < C2 ? rnd<OT>(to_f(dcp[(long long)r * C2 + n])) : 0.f;
  };
  float acc[4][2] = {};
  tile_gemm<true, true>(la, lb, r0, r1, m0, n0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* out = part + (long long)blockIdx.z * M * C2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + tx * 2 + j;
      if (n < C2) out[(long long)m * C2 + n] = acc[i][j];
    }
  }
}

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

// Scratch: z, do_ [B*T, 2C] f32; h [B*T, C] OT; dy [B*T, C] f32; wpart
// [(B*T / seg_rows) * ceil(seg_rows / rch), 3C, 2C] f32; cpart
// [max((B*T / seg_rows) * ceil(seg_rows / cch) * 2C, B * ceil(T / cch) * C)]
// f32; gsum [B*T / seg_rows, 2C] f32 (unused when seg_rows = B*T).
template <typename OT, typename DT, typename GT>
int run_bwd(const OT* xs, const float* sb, const OT* cond, const OT* wd,
            const float* bd, const OT* wo, const GT* dout, float* dx,
            float* dsb, DT* dcp, float* dwd, float* dbd, float* dwo,
            float* dbo, float* z, OT* h, float* do_, float* dy, float* wpart,
            float* cpart, float* gsum, int B, int T_, int C, int L, int cycle,
            int seg_rows, int rch, int cch, cudaStream_t s) {
  const int rows = B * T_, C2 = 2 * C;
  if (seg_rows <= 0 || rows % seg_rows) return static_cast<int>(cudaErrorInvalidValue);
  const long long RC = (long long)rows * C, RC2 = (long long)rows * C2;
  const int nseg = rows / seg_rows, cps = (seg_rows + rch - 1) / rch;
  const int nchw = nseg * cps;
  const dim3 grid_rc((rows + BM - 1) / BM, (C + BN - 1) / BN);
  const dim3 grid_wo((C + BM - 1) / BM, (C2 + BN - 1) / BN, nchw);
  const dim3 grid_wd((3 * C + BM - 1) / BM, (C2 + BN - 1) / BN, nchw);
  cudaError_t e = cudaMemsetAsync(dx, 0, RC * sizeof(float), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int l = L - 1; l >= 0; --l) {
    const int d = 1 << (l % cycle);
    const OT* xs_l = xs + l * RC;
    const float* sb_l = sb + (long long)l * B * C;
    const OT* wd_l = wd + (long long)l * 3 * C * C2;
    const OT* wo_l = wo + (long long)l * C * C2;
    DT* dcp_l = dcp + l * RC2;
    gate_kernel<OT, OT, float><<<grid_rc, NT, 0, s>>>(
        xs_l, sb_l, C, cond + l * RC2, wd_l, bd + (long long)l * C2, h, z, B,
        T_, C, d);
    DSVC_LAUNCH_CHECK();
    make_do_kernel<GT><<<grid1d(RC2), 256, 0, s>>>(dx, dout, do_, rows, C);
    DSVC_LAUNCH_CHECK();
    dh_kernel<OT, DT><<<grid_rc, NT, 0, s>>>(do_, wo_l, z, dcp_l, rows, C);
    DSVC_LAUNCH_CHECK();
    dy_kernel<OT, DT><<<grid_rc, NT, 0, s>>>(dcp_l, wd_l, dy, dx, B, T_, C,
                                             d);
    DSVC_LAUNCH_CHECK();
    wgrad_out_kernel<OT><<<grid_wo, NT, 0, s>>>(h, do_, wpart, C, seg_rows,
                                                cps, rch);
    DSVC_LAUNCH_CHECK();
    sum_chunks_kernel<<<grid1d((long long)C * C2), 256, 0, s>>>(
        wpart, nseg, cps, (long long)C * C2, dwo + (long long)l * C * C2);
    DSVC_LAUNCH_CHECK();
    wgrad_dil_kernel<OT, DT><<<grid_wd, NT, 0, s>>>(
        xs_l, sb_l, dcp_l, wpart, T_, C, d, seg_rows, cps, rch);
    DSVC_LAUNCH_CHECK();
    sum_chunks_kernel<<<grid1d(3LL * C * C2), 256, 0, s>>>(
        wpart, nseg, cps, 3LL * C * C2, dwd + (long long)l * 3 * C * C2);
    DSVC_LAUNCH_CHECK();
    int err = colsum_segments(do_, rows, C2, seg_rows, cch, cpart, gsum,
                              dbo + (long long)l * C2, s);
    if (err) return err;
    err = colsum_segments(z, rows, C2, seg_rows, cch, cpart, gsum,
                          dbd + (long long)l * C2, s);
    if (err) return err;
    err = colsum(dy, rows, C, T_, cch, cpart, dsb + (long long)l * B * C, s);
    if (err) return err;
  }
  return 0;
}

}  // namespace
