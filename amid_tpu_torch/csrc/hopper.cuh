// Hopper (sm_90a) pieces the wgmma kernels share (affinity.cu,
// attention_bwd_long.cu): shared-memory addresses, mbarriers, asynchronous
// copies into shared memory, the wgmma fences and the shared-memory matrix
// descriptor.
//
// Descriptors here are of K-major operands without swizzle: the operand is
// cut into core matrices of 8 rows x 16 bytes, each 128 contiguous bytes
// (row r of the core matrix at byte 16 r); the leading byte offset is the
// distance between core matrices next to each other along K, the stride
// byte offset the distance between core matrices next to each other along M
// (or N). A k-step of 32 bytes (k16 in bf16, k8 in tf32) reads two core
// matrices along K.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace amid_hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes (both addresses 16-byte aligned) from global to shared memory,
// or 16 zero bytes where `in` is false (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes, or a zero where `in` is false
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// one arrival on `bar` once every cp.async this thread issued before has
// landed (the barrier's count includes this arrival: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma reads its shared-memory operands through it)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a K-major operand without swizzle at shared address `addr`;
// `lbo` and `sbo` in bytes (multiples of 16). Adding 1 moves the start by
// 16 bytes.
__device__ __forceinline__ uint64_t matrix_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
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
// keeps the compiler from moving accesses of an accumulator (or of a
// register operand) across a wgmma.fence or wgmma.wait_group: the product
// reads and writes them asynchronously
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

}  // namespace amid_hopper
