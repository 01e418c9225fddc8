// Order-0 and order-1 32-lane rANS 32x16 decode walks for many streams.
//
// Replace the TPU kernels fqzcomp5_tpu/ops/rans_pallas_dec.py::
// decode_walk4v5 (_decode_kernel4v5, order-0) and ::decode_walk4v5_o1
// (_decode_kernel4v5_o1, order-1).  They compute what rans_jax.decode_scan
// and decode_scan_o1 compute: per step, every active lane looks its slot
// R & (tot-1) up in the s3 table (freq << (shift+8) | bias << 8 | sym),
// advances R, and the lanes whose state fell below 2^15 read the next
// words of the shared stream in lane order.  The TPU kernels had no
// per-lane gather, so they searched boundary tables by compare-reduction,
// remapped order-1 alphabets to at most 64 dense symbols, and fed words
// through rolled DMA windows.  Here the order-0 walk gives one warp to a
// stream: the symbol is one gather from the stream's s3 table (16 KB) in
// shared memory, and the renormalising lanes take consecutive words at
// ptr + popc(ballot & lanes_below) (fqz5::feed_words, rans_dec_common.cuh,
// shared with rans_decode_bnd.cu).  The order-1 walk gives a block to a
// stream, described above decode_o1_kernel.  There is no alphabet limit.
//
// What bounds them on the H100: per step, the dependent chain R -> table
// lookup -> multiply -> word -> R; a stream cannot be split, since each
// lane's next word position depends on every lane's renormalisation.
// The order-0 walk still reads its words from global memory on that
// chain.  The order-1 tables (256 contexts x 4096 slots x 4 B = 4 MB per
// stream at shift 12) do not fit shared memory as s3; their compact form
// does for the alphabets the main path has.  Traffic per symbol is one
// byte out plus at most two bytes of words in.
//
// A symbol whose frequency is the whole total (a single-symbol stream,
// or a single-symbol order-1 context at shift 12) stores f << (shift+8)
// = 2^32, which wraps to 0 in the u32 table.  A zero frequency field
// therefore means f = tot, as in the TPU kernels' repaired tables; taken
// as 0 (as rans_jax.decode_scan/decode_scan_o1 take it) it would make
// every such step renormalise: harmless for a single-symbol order-0
// stream, whose symbols stay right, but wrong for every later symbol of
// an order-1 lane.  Steps at or past a stream's t_real neither move
// the state nor consume words; they write the symbol of the frozen state
// (order-0) or the last symbol (order-1), as the scans do.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "rans_dec_common.cuh"
#include "smem_async.cuh"

namespace {

using namespace fqz5;

constexpr int kO0Shift = 12;
constexpr int kO0Tot = 1 << kO0Shift;

__global__ void decode_o0_kernel(const uint16_t* __restrict__ words,
                                 long long W,
                                 const uint32_t* __restrict__ R0,
                                 const uint32_t* __restrict__ s3,
                                 const int32_t* __restrict__ t_real, int T,
                                 uint8_t* __restrict__ syms,
                                 uint32_t* __restrict__ Rf) {
    __shared__ uint32_t lut[kO0Tot];
    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    const uint32_t* s3b = s3 + (long long)b * kO0Tot;
    for (int k = lane; k < kO0Tot; k += 32) lut[k] = s3b[k];
    __syncwarp();

    const uint16_t* w = words + (long long)b * W;
    uint8_t* out = syms + (long long)b * T * 32;
    const uint32_t lt_mask = (1u << lane) - 1u;
    const int tr = min(t_real[b], T);
    uint32_t R = R0[b * 32 + lane];
    long long ptr = 0;
    for (int t = 0; t < tr; ++t) {
        const uint32_t S = lut[R & (kO0Tot - 1)];
        uint32_t F = S >> (kO0Shift + 8);
        if (F == 0) F = kO0Tot;
        uint32_t Rn = F * (R >> kO0Shift) + ((S >> 8) & (kO0Tot - 1));
        Rn = fqz5::feed_words(Rn, w, W, ptr, lt_mask);
        out[(long long)t * 32 + lane] = (uint8_t)(S & 0xFF);
        R = Rn;
    }
    const uint8_t frozen = (uint8_t)(lut[R & (kO0Tot - 1)] & 0xFF);
    for (int t = tr; t < T; ++t) out[(long long)t * 32 + lane] = frozen;
    Rf[b * 32 + lane] = R;
}

// ---------------------------------------------------------------------
// Order-1: one block per stream.
//
// All 12 warps first build the stream's tables (the prologue): the
// alphabet is every byte some s3 entry decodes, plus byte 0 (the initial
// context), numbered in byte order, so byte 0 is code 0; A codes in all.
// Per context code c, a u8 slot table gives for each slot m the code of
// its symbol, or the code A for an empty (zero) s3 entry, and a packed
// word per (c, code) gives the symbol's f (a zero frequency field read as
// tot) and start: P = f << 16 | start, and for code A, f = tot with the
// zero flag (bit 12: bias 0, byte 0, as a zero s3 entry decodes).  Each slot's
// bias is then m - start, which holds for s3 rows as rans_F_to_s3 and
// rans_torch.build_s3 make them: each symbol's slots one run, bias 0 up.
// A step is two dependent shared loads (slot code, packed word), one
// multiply-add and the renormalisation.  Where the tables do not fit the
// block's shared memory (A * tot + 4 * A * (A + 1) bytes; at shift 12 up
// to A = 51, at shift 10 up to A = 140), the same walk reads them from
// the stream's scratch in global memory; a stream that uses all 256
// bytes (no code is left for the zero entry) walks its s3 LUT as the
// first port did.  The route is chosen per stream from A, before the
// walk; nothing is retried.
//
// Then warp 0 walks (lane z is state z), warp 1 keeps the stream's next
// words in a shared-memory ring (4 stages of 512 words, 16-byte cp.async
// for whole chunks of the row, handed over on mbarriers), and warp 2
// writes the symbol rows, staged by the walker in shared memory (2
// stages of 64 steps), to global memory in 16-byte stores, translating
// codes to bytes.  No global load is left on a step's chain.
constexpr int kO1Threads = 384;
constexpr int kRingStages = 4;
constexpr int kRingStage = 512;               // words
constexpr int kRingWords = kRingStages * kRingStage;
constexpr int kGroup = 8;                     // steps between ring checks
constexpr int kSymSteps = 64;                 // steps a symbol stage holds
constexpr int kSymStages = 2;
constexpr uint32_t kZeroFlag = 1u << 12;
constexpr int kSmemBytes = 232448;            // the most a block may use
enum { kRouteShared = 0, kRouteGlobal = 1, kRouteS3 = 2 };

struct O1Head {
    uint16_t ring[kRingWords];
    uint8_t sym[kSymStages][kSymSteps * 32];
    uint8_t alpha[256];       // code -> byte
    uint8_t dense[256];       // byte -> code
    uint8_t present[256];
    uint8_t last[32];         // each lane's last byte, for rows past t_real
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

// The stream's word ptr + lane for lane `lane`, from the ring: word i of
// the row sits at ring slot (i + off) mod the ring; past the row's last
// word (a corrupt stream) it is that word, held in lastw, as
// fqz5::feed_words' clip reads it.
__device__ __forceinline__ uint32_t ring_word(uint32_t ring, uint32_t ptr,
                                              uint32_t off, uint32_t W,
                                              uint32_t lastw, int lane) {
    const uint32_t i = ptr + lane;
    const uint32_t v = lds_u16(ring + 2 * ((i + off) & (kRingWords - 1)));
    return i < W ? v : lastw;
}

// Renormalise from the ring: fqz5::feed_words with the stream's next 32
// words already in the lanes (pw, from ring_word): the renormalising
// lanes take theirs by one shuffle, so no load address waits on the
// ballot.
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

// One step through the compact tables (shared or global): the slot's code,
// then the (context, code) word.  ctx is the context's code.
template <bool SHARED>
struct CompactStep {
    uint32_t slot, ptab;                  // shared addresses
    const uint8_t* gslot;                 // or global tables
    const uint32_t* gptab;
    uint32_t A, A1, shift, mask;
    uint32_t cbase = 0, prow = 0, ctx = 0;

    __device__ __forceinline__ uint32_t operator()(uint32_t R) {
        const uint32_t m = R & mask;
        uint32_t code, P;
        if (SHARED) {
            code = lds_u8(slot + cbase + m);
            P = lds_u32(ptab + prow + 4 * code);
        } else {
            code = gslot[cbase + m];
            P = gptab[prow / 4 + code];
        }
        ctx = code == A ? 0u : code;
        cbase = ctx << shift;
        prow = 4 * ctx * A1;
        const uint32_t start = (P & kZeroFlag) ? m : P & 0xFFFu;
        return (P >> 16) * (R >> shift) + m - start;
    }
};

// One step through the stream's s3 LUT in global memory (a 256-byte
// alphabet); ctx is the last byte.
struct S3Step {
    const uint32_t* s3b;
    uint32_t shift, mask, tot;
    uint32_t ctx = 0;

    __device__ __forceinline__ uint32_t operator()(uint32_t R) {
        const uint32_t S = __ldg(s3b + (ctx << shift) + (R & mask));
        uint32_t F = S >> (shift + 8);
        if (F == 0) F = tot;
        ctx = S & 0xFF;
        return F * (R >> shift) + ((S >> 8) & mask);
    }
};

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
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
            if (t0 + j < tr) {
                R = ring_feed(step(R), pw, ptr, lt_mask);
                if (j + 1 < kGroup)
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

// warp 1: the ring, stage k holding ring positions [k, k + 1) * kRingStage,
// until the walker raises stop
__device__ void o1_feed(O1Head& h, const uint16_t* w, uint32_t W,
                        uint32_t off, int lane) {
    const char* base = reinterpret_cast<const char*>(w) - 2 * off;
    for (uint32_t k = 0;; ++k) {
        const int s = k % kRingStages;
        if (k >= kRingStages) {
            const uint32_t parity = ((k / kRingStages) - 1) & 1;
            for (uint32_t polls = 0; !mbar_try_wait(&h.empty[s], parity);) {
                if (h.stop) return;
                if (++polls == 1u << 26) __trap();
            }
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

// warp 2: staged rows out as bytes, then the rows past t_real
__device__ void o1_write(O1Head& h, uint8_t* o, int tr, int T, int lane) {
    const int nst = (tr + kSymSteps - 1) / kSymSteps;
    for (int k = 0; k < nst; ++k) {
        const int s = k & 1;
        mbar_wait(&h.sfull[s], (k >> 1) & 1);
        const int rows = min(kSymSteps, tr - k * kSymSteps);
        const uint4* src = reinterpret_cast<const uint4*>(h.sym[s]);
        uint4* dst = reinterpret_cast<uint4*>(o + (size_t)k * kSymSteps * 32);
        for (int i = lane; i < rows * 2; i += 32) {
            uint4 v = src[i];
            v.x = to_bytes(v.x, h.alpha);
            v.y = to_bytes(v.y, h.alpha);
            v.z = to_bytes(v.z, h.alpha);
            v.w = to_bytes(v.w, h.alpha);
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

__global__ void __launch_bounds__(kO1Threads)
decode_o1_kernel(const uint16_t* __restrict__ words, long long W,
                 const uint32_t* __restrict__ R0,
                 const uint32_t* __restrict__ s3, int shift,
                 const int32_t* __restrict__ t_real, int T,
                 uint8_t* __restrict__ syms, uint32_t* __restrict__ Rf,
                 int32_t* __restrict__ ptrf, uint8_t* __restrict__ scratch,
                 long long scratch_stride) {
    extern __shared__ __align__(16) unsigned char smem[];
    O1Head& h = *reinterpret_cast<O1Head*>(smem);
    unsigned char* tables = smem + kHeadBytes;
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const uint32_t tot = 1u << shift;
    const uint32_t mask = tot - 1u;
    const uint32_t* s3b = s3 + (size_t)b * 256 * tot;

    // prologue 1: the alphabet
    for (int i = tid; i < 256; i += kO1Threads) h.present[i] = i == 0;
    if (tid == 0) {
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
    __syncthreads();
    const uint4* s3v = reinterpret_cast<const uint4*>(s3b);
    for (uint32_t i = tid; i < 64 * tot; i += kO1Threads) {
        const uint4 v = __ldg(s3v + i);
        if (v.x) h.present[v.x & 0xFF] = 1;
        if (v.y) h.present[v.y & 0xFF] = 1;
        if (v.z) h.present[v.z & 0xFF] = 1;
        if (v.w) h.present[v.w & 0xFF] = 1;
    }
    __syncthreads();
    if (warp == 0) {
        uint32_t n = 0;
        for (int k = 0; k < 8; ++k) n += h.present[lane * 8 + k];
        uint32_t incl = n;
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t v = __shfl_up_sync(0xffffffffu, incl, d);
            if (lane >= d) incl += v;
        }
        uint32_t code = incl - n;
        for (int k = 0; k < 8; ++k) {
            const int byte = lane * 8 + k;
            if (h.present[byte]) {
                h.dense[byte] = (uint8_t)code;
                h.alpha[code++] = (uint8_t)byte;
            }
        }
        if (lane == 31) {
            const int A = (int)incl;
            h.A = A;
            h.route = A > 255 ? kRouteS3
                      : (long long)A * tot + 4LL * A * (A + 1) <= kTableBytes
                          ? kRouteShared : kRouteGlobal;
        }
    }
    __syncthreads();
    const int A = h.A;
    const int route = h.route;
    const uint32_t A1 = A + 1;

    // prologue 2: the compact tables
    uint8_t* slot8 = nullptr;
    uint32_t* ptab = nullptr;
    if (route == kRouteS3) {
        for (int i = tid; i < 256; i += kO1Threads) h.alpha[i] = (uint8_t)i;
    } else {
        unsigned char* t = route == kRouteShared
                               ? tables : scratch + (size_t)b * scratch_stride;
        ptab = reinterpret_cast<uint32_t*>(t);
        slot8 = t + 4 * (size_t)A * A1;
        for (int c = tid; c < A; c += kO1Threads)
            ptab[c * A1 + A] = tot << 16 | kZeroFlag;
        const uint32_t rowv = tot / 4;   // uint4 a context row
        for (uint32_t i = tid; i < (uint32_t)A * rowv; i += kO1Threads) {
            const uint32_t c = i / rowv, q = i % rowv;
            const uint4 v = __ldg(s3v + h.alpha[c] * rowv + q);
            const uint32_t S[4] = {v.x, v.y, v.z, v.w};
            uint32_t codes = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                uint32_t code = A;
                if (S[e]) {
                    code = h.dense[S[e] & 0xFF];
                    uint32_t f = S[e] >> (shift + 8);
                    if (f == 0) f = tot;
                    const uint32_t start = q * 4 + e - ((S[e] >> 8) & mask);
                    ptab[c * A1 + code] = f << 16 | (start & 0xFFFu);
                }
                codes |= code << (8 * e);
            }
            reinterpret_cast<uint32_t*>(slot8)[c * rowv + q] = codes;
        }
    }
    __syncthreads();

    const int tr = max(0, min(t_real[b], T));
    const uint16_t* w = words + (size_t)b * W;
    const uint32_t off =
        (uint32_t)(reinterpret_cast<uintptr_t>(w) & 15) >> 1;
    if (warp == 1) {
        o1_feed(h, w, (uint32_t)W, off, lane);
        return;
    }
    if (warp == 2) {
        o1_write(h, syms + (size_t)b * T * 32, tr, T, lane);
        return;
    }
    if (warp != 0) return;

    uint32_t R = R0[b * 32 + lane];
    uint32_t ptr = 0;
    const uint32_t lastw = w[W - 1];
    uint32_t last;
    if (route == kRouteS3) {
        S3Step st{s3b, (uint32_t)shift, mask, tot};
        o1_walk(h, st, R, ptr, tr, (uint32_t)W, off, lastw, lane);
        last = st.ctx;
    } else if (route == kRouteShared) {
        CompactStep<true> st{smem_addr(slot8), smem_addr(ptab), nullptr,
                             nullptr, (uint32_t)A, A1, (uint32_t)shift, mask};
        o1_walk(h, st, R, ptr, tr, (uint32_t)W, off, lastw, lane);
        last = h.alpha[st.ctx];
    } else {
        CompactStep<false> st{0, 0, slot8, ptab, (uint32_t)A, A1,
                              (uint32_t)shift, mask};
        o1_walk(h, st, R, ptr, tr, (uint32_t)W, off, lastw, lane);
        last = h.alpha[st.ctx];
    }
    h.stop = 1;
    h.last[lane] = (uint8_t)last;
    pair_sync();
    Rf[b * 32 + lane] = R;
    if (lane == 0) ptrf[b] = (int32_t)ptr;
}

}  // namespace

extern "C" int fqz5_rans_decode_o0(const uint16_t* words, long long W,
                                   const uint32_t* R0, const uint32_t* s3,
                                   const int32_t* t_real, int B, int T,
                                   uint8_t* syms, uint32_t* Rf,
                                   void* stream) {
    decode_o0_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
        words, W, R0, s3, t_real, T, syms, Rf);
    return (int)cudaGetLastError();
}

extern "C" int fqz5_rans_decode_o1(const uint16_t* words, long long W,
                                   const uint32_t* R0, const uint32_t* s3,
                                   int shift, const int32_t* t_real, int B,
                                   int T, uint8_t* syms, uint32_t* Rf,
                                   int32_t* ptrf, uint8_t* scratch,
                                   long long scratch_stride, void* stream) {
    if (B <= 0) return 0;
    if (W < 1 || W > INT_MAX || (long long)T * 32 > INT_MAX)
        return (int)cudaErrorInvalidValue;
    const cudaError_t attr = cudaFuncSetAttribute(
        decode_o1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (attr != cudaSuccess) return (int)attr;
    decode_o1_kernel<<<B, kO1Threads, kSmemBytes, (cudaStream_t)stream>>>(
        words, W, R0, s3, shift, t_real, T, syms, Rf, ptrf, scratch,
        scratch_stride);
    return (int)cudaGetLastError();
}
