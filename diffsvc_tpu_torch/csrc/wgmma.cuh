// Building blocks of the tensor-core kernels (K1/K2 in diffnet_layer_tc.cuh
// and diffnet_layer_tf32x3.cuh, K3 in vocoder_tail.cu): cp.async into the
// 128-byte swizzled K-major tiles that wgmma's shared-memory descriptors
// read, the descriptors, the wgmma fences and waits, and TF32 rounding.
#pragma once

#include "common.cuh"

// Internal linkage: every .cu file that includes this header links into one
// library.
namespace {
namespace wg {

constexpr int ALIGN = 1024;     // the 128-byte swizzle repeats every 1 KB

// Opt in to more than 48 KB of dynamic shared memory, and prefer the
// largest shared-memory carveout, so that as many CTAs fit an SM as its
// 228 KB allow.
template <typename K>
int allow_smem(K kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return static_cast<int>(e);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Offset that brings the dynamic shared memory to a 1 KB boundary (the
// plans reserve ALIGN bytes for it).
__device__ __forceinline__ uint32_t align_pad(const void* raw) {
  return (ALIGN - (smem_u32(raw) & (ALIGN - 1))) & (ALIGN - 1);
}

// Byte offset of 16-byte chunk `ch` (0-7) of row `r` in a tile of 128-byte
// rows with the 128-byte swizzle (what TMA's SWIZZLE_128B writes and what a
// wgmma descriptor of layout type 1 reads).
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return static_cast<uint32_t>(r * 128 + ((ch ^ (r & 7)) << 4));
}

// 16-byte async copy; zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Make this thread's generic-proxy shared-memory writes (cp.async, st)
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1 KB apart (SBO); the leading offset is unused for this layout.
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(ALIGN >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator accesses across the async
// wgmma boundaries.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// v rounded to the nearest TF32 value, ties away from zero, its 13 low bits
// zero.
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

}  // namespace wg
}  // namespace
