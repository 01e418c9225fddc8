// The block layout the 32-lane rANS 32x16 decode walks share
// (rans_decode.cu: decode_o0, decode_o1; rans_decode_bnd.cu:
// decode_bnd_o0, decode_dense_o1): one block a stream, whose warps first
// build the stream's tables in shared memory (each kernel its own
// prologue), then split three ways.  Warp 0 walks (lane z is state z),
// warp 1 keeps the stream's next words in a shared-memory ring
// (kRingStages stages of kRingStage words, 16-byte cp.async for whole
// chunks of the row, handed over on mbarriers), and warp 2 writes the
// symbol rows, staged by the walker in shared memory (kSymStages stages of
// kSymSteps steps), to global memory in 16-byte stores.  A step reads only
// shared memory (or the stream's tables in global scratch, where they do
// not fit): the renormalising lanes take their words from the ring by one
// shuffle.
//
// What differs between the walks is a Step functor (o1_walk's template
// parameter: the table lookup and the state's advance, leaving the step's
// symbol code in step.ctx), whether the writer maps codes to bytes through
// h.alpha (o1_write's kAlpha), and what the rows past t_real hold, which
// the walker leaves in h.last before its last pair_sync.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_async.cuh"

namespace fqz5 {

constexpr uint32_t kRansL = 1u << 15;         // renormalisation bound

constexpr int kRingStages = 4;
constexpr int kRingStage = 512;               // words
constexpr int kRingWords = kRingStages * kRingStage;
constexpr int kGroup = 32;                    // steps between ring checks
constexpr int kSymSteps = 64;                 // steps a symbol stage holds
constexpr int kSymStages = 2;
constexpr int kSmemBytes = 232448;            // the most a block may use
enum { kRouteShared = 0, kRouteGlobal = 1, kRouteS3 = 2 };

struct O1Head {
    uint16_t ring[kRingWords];
    uint8_t sym[kSymStages][kSymSteps * 32];
    uint8_t alpha[256];       // code -> byte
    uint8_t dense[256];       // byte -> code
    uint8_t present[256];
    uint8_t last[32];         // each lane's byte for the rows past t_real
    uint64_t full[kRingStages];    // feeder -> walker: a ring stage is in
    uint64_t empty[kRingStages];   // walker -> feeder: a stage is used up
    uint64_t sfull[kSymStages];    // walker -> writer: symbol rows staged
    uint64_t sempty[kSymStages];   // writer -> walker: rows written out
    int A, route;
    volatile int stop;             // the walk is over: the feeder leaves
};
constexpr int kHeadBytes = (sizeof(O1Head) + 15) & ~15;
constexpr int kTableBytes = kSmemBytes - kHeadBytes;

__device__ __forceinline__ uint32_t lds_u8(uint32_t a) {
    uint32_t v;
    asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(a));
    return v;
}

__device__ __forceinline__ uint32_t lds_u16(uint32_t a) {
    uint32_t v;
    asm volatile("ld.shared.u16 %0, [%1];" : "=r"(v) : "r"(a));
    return v;
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t a) {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
    return v;
}

__device__ __forceinline__ void sts_u8(uint32_t a, uint32_t v) {
    asm volatile("st.shared.u8 [%0], %1;" :: "r"(a), "r"(v) : "memory");
}

// walker and writer: warps 0 and 2
__device__ __forceinline__ void pair_sync() {
    asm volatile("bar.sync 1, 64;" ::: "memory");
}

// Thread 0 of the block: the hand-over barriers, before the block's first
// __syncthreads.
__device__ __forceinline__ void head_init(O1Head& h) {
    for (int s = 0; s < kRingStages; ++s) {
        mbar_init(&h.full[s], 32);
        mbar_init(&h.empty[s], 1);
    }
    for (int s = 0; s < kSymStages; ++s) {
        mbar_init(&h.sfull[s], 1);
        mbar_init(&h.sempty[s], 1);
    }
    mbar_fence_init();
    h.stop = 0;
}

// The stream's word ptr + lane for lane `lane`, from the ring: word i of
// the row sits at ring slot (i + off) mod the ring; past the row's last
// word (a corrupt stream) it is that word, held in lastw, as
// rans_jax.decode_scan clips its reads.
__device__ __forceinline__ uint32_t ring_word(uint32_t ring, uint32_t ptr,
                                              uint32_t off, uint32_t W,
                                              uint32_t lastw, int lane) {
    const uint32_t i = ptr + lane;
    const uint32_t v = lds_u16(ring + 2 * ((i + off) & (kRingWords - 1)));
    return i < W ? v : lastw;
}

// Renormalise the lanes whose new state Rn fell below 2^15: they take the
// stream's next words in lane order, lane z the word at ptr + popc(the
// renormalising lanes below z), and ptr moves past all of them.  The
// stream's next 32 words are already in the lanes (pw, from ring_word),
// so the renormalising lanes take theirs by one shuffle and no load
// address waits on the ballot.
__device__ __forceinline__ uint32_t ring_feed(uint32_t Rn, uint32_t pw,
                                              uint32_t& ptr,
                                              uint32_t lt_mask) {
    const bool need = Rn < kRansL;
    const uint32_t bal = __ballot_sync(0xffffffffu, need);
    const uint32_t v = __shfl_sync(0xffffffffu, pw, __popc(bal & lt_mask));
    if (need) Rn = (Rn << 16) | v;
    ptr += __popc(bal);
    return Rn;
}

// Warp 0: tr steps of the walk, step(R) giving each lane's state before
// renormalisation and leaving the step's symbol code in step.ctx, which
// is staged for the writer.  The ring is checked once a group of kGroup
// steps: the walker waits until it holds the 32 * kGroup words the group
// may take (two stages past the current one, while the feeder fills the
// fourth), so no step waits on a barrier.
template <class Step>
__device__ __forceinline__ void o1_walk(O1Head& h, Step& step, uint32_t& R,
                                        uint32_t& ptr, int tr, uint32_t W,
                                        uint32_t off, uint32_t lastw,
                                        int lane) {
    const uint32_t lt_mask = (1u << lane) - 1u;
    const uint32_t ring = smem_addr(h.ring);
    uint32_t navail = 0, rel = 0;   // ring positions (word index + off)
    uint32_t pw;                    // the word at ptr + lane
    for (int t0 = 0; t0 < tr; t0 += kGroup) {
        const int k = t0 / kSymSteps;
        const int s = k & 1;
        if (t0 % kSymSteps == 0 && k >= kSymStages)
            mbar_wait(&h.sempty[s], ((k >> 1) - 1) & 1);
        // hand back the ring stages whose words are all consumed, then
        // wait until the ring holds every word this group may take
        while (rel + kRingStage <= ptr + off) {
            __syncwarp();
            if (lane == 0)
                mbar_arrive(&h.empty[(rel / kRingStage) % kRingStages]);
            rel += kRingStage;
        }
        while (navail < ptr + off + 32 * kGroup) {
            const uint32_t j = navail / kRingStage;
            mbar_wait(&h.full[j % kRingStages], (j / kRingStages) & 1);
            navail += kRingStage;
        }
        const uint32_t row = smem_addr(h.sym[s]) + (t0 % kSymSteps) * 32 + lane;
        pw = ring_word(ring, ptr, off, W, lastw, lane);
        // a full group runs straight; a step guarded inside the unrolled
        // group put its warp collectives in a conditional block, and the
        // reconvergence around each cost about 55 cycles a step
        if (t0 + kGroup <= tr) {
#pragma unroll
            for (int j = 0; j < kGroup; ++j) {
                R = ring_feed(step(R), pw, ptr, lt_mask);
                if (j + 1 < kGroup)
                    pw = ring_word(ring, ptr, off, W, lastw, lane);
                sts_u8(row + j * 32, step.ctx);
            }
        } else {
            for (int j = 0; t0 + j < tr; ++j) {
                R = ring_feed(step(R), pw, ptr, lt_mask);
                pw = ring_word(ring, ptr, off, W, lastw, lane);
                sts_u8(row + j * 32, step.ctx);
            }
        }
        if ((t0 + kGroup) % kSymSteps == 0 || t0 + kGroup >= tr) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&h.sfull[s]);
        }
    }
}

// Warp 1: the ring, stage k holding ring positions [k, k + 1) * kRingStage,
// until the walker raises stop.  Its wait for a used-up stage lasts as
// long as the walker takes to consume a stage's words, which a stream
// that rarely renormalises may stretch over its whole walk, so that wait
// ends on stop and never traps (the walker's own waits do).
__device__ inline void o1_feed(O1Head& h, const uint16_t* w, uint32_t W,
                               uint32_t off, int lane) {
    const char* base = reinterpret_cast<const char*>(w) - 2 * off;
    for (uint32_t k = 0;; ++k) {
        const int s = k % kRingStages;
        if (k >= kRingStages) {
            const uint32_t parity = ((k / kRingStages) - 1) & 1;
            while (!mbar_try_wait(&h.empty[s], parity))
                if (h.stop) return;
        }
        for (uint32_t c = k * (kRingStage / 8) + lane;
             c < (k + 1) * (kRingStage / 8); c += 32) {
            const uint32_t q0 = c * 8;   // 8 words, 16 bytes, a chunk
            uint16_t* dst = h.ring + (q0 & (kRingWords - 1));
            if (q0 >= off && q0 + 8 <= off + W) {
                cp_async16(dst, base + 16 * (size_t)c);
            } else if (q0 < off + W && q0 + 8 > off) {
                for (uint32_t e = 0; e < 8; ++e)
                    if (q0 + e >= off && q0 + e < off + W)
                        dst[e] = w[q0 + e - off];
            }
        }
        cp_async_commit();
        cp_async_wait<0>();
        mbar_arrive(&h.full[s]);
        if (h.stop) return;
    }
}

__device__ __forceinline__ uint32_t to_bytes(uint32_t v, const uint8_t* a) {
    return a[v & 0xFF] | a[(v >> 8) & 0xFF] << 8 | a[(v >> 16) & 0xFF] << 16 |
           (uint32_t)a[v >> 24] << 24;
}

// Warp 2: staged rows out (as bytes through h.alpha when kAlpha, else as
// the codes they are), then the rows past t_real, each lane's h.last.
template <bool kAlpha>
__device__ inline void o1_write(O1Head& h, uint8_t* o, int tr, int T,
                                int lane) {
    const int nst = (tr + kSymSteps - 1) / kSymSteps;
    for (int k = 0; k < nst; ++k) {
        const int s = k & 1;
        mbar_wait(&h.sfull[s], (k >> 1) & 1);
        const int rows = min(kSymSteps, tr - k * kSymSteps);
        const uint4* src = reinterpret_cast<const uint4*>(h.sym[s]);
        uint4* dst = reinterpret_cast<uint4*>(o + (size_t)k * kSymSteps * 32);
        for (int i = lane; i < rows * 2; i += 32) {
            uint4 v = src[i];
            if (kAlpha) {
                v.x = to_bytes(v.x, h.alpha);
                v.y = to_bytes(v.y, h.alpha);
                v.z = to_bytes(v.z, h.alpha);
                v.w = to_bytes(v.w, h.alpha);
            }
            dst[i] = v;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&h.sempty[s]);
    }
    pair_sync();   // the walker has filled h.last
    const uint4* last = reinterpret_cast<const uint4*>(h.last);
    uint4* dst = reinterpret_cast<uint4*>(o);
    for (size_t i = (size_t)tr * 2 + lane; i < (size_t)T * 2; i += 32)
        dst[i] = last[i & 1];
}

// The stream's word row: where in the 16-byte chunks its first word falls
// (the feeder copies whole chunks), and its last word (the clip's).
__device__ __forceinline__ uint32_t row_off(const uint16_t* w) {
    return (uint32_t)(reinterpret_cast<uintptr_t>(w) & 15) >> 1;
}

// Warps 1 and 2 take their parts and leave (true); warp 0 goes on to walk
// (false), and ends by filling h.last, raising h.stop and pair_sync().
template <bool kAlpha>
__device__ __forceinline__ bool feed_or_write(O1Head& h, int warp,
                                              const uint16_t* w, uint32_t W,
                                              uint32_t off, uint8_t* o,
                                              int tr, int T, int lane) {
    if (warp == 1) {
        o1_feed(h, w, W, off, lane);
        return true;
    }
    if (warp == 2) {
        o1_write<kAlpha>(h, o, tr, T, lane);
        return true;
    }
    return warp != 0;
}

}  // namespace fqz5
