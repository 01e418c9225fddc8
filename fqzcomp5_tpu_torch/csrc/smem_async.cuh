// Shared-memory staging primitives for the encode walks (sm_90a): 4-byte
// cp.async copies from global memory, their commit groups, and mbarriers
// for handing stages between producer warps and a consumer thread.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fqz5 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// dst (shared) <- 4 bytes at src (global), asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// dst (shared) <- 16 bytes at src (global), both 16-byte aligned,
// asynchronously, not cached in L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival, with release semantics for this thread's earlier writes
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("{\n\t.reg .b64 st;\n\t"
                 "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
    uint32_t ok;
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}\n"
                 : "=r"(ok) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    return ok != 0;
}

// Wait until the barrier's phase of the given parity has completed.  A
// hand-over takes microseconds; one that never comes (a broken protocol)
// traps after 2^26 polls, which fails the launch instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    for (uint32_t polls = 0; !mbar_try_wait(bar, parity);)
        if (++polls == 1u << 26) __trap();
}

}  // namespace fqz5
