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
// through rolled DMA windows.  Here both walks give a block to a stream,
// in the layout of rans_dec_walk.cuh: a walker warp whose step reads only
// shared memory, a feeder warp that keeps the stream's words in a shared
// ring, and a writer warp that stores 16-byte symbol rows.  At order-0
// the stream's s3 table (16 KB) sits in shared memory and a step is one
// load of its word, one multiply-add and the renormalisation; a block
// takes about 25 KB, so several streams share an SM when there are more
// streams than SMs.  The order-1 walk is described above
// decode_o1_kernel.  There is no alphabet limit.
//
// What bounds them on the H100: per step, the dependent chain R -> table
// lookup -> multiply -> ballot -> word shuffle -> R; a stream cannot be
// split, since each lane's next word position depends on every lane's
// renormalisation.  The order-1 tables (256 contexts x 4096 slots x 4 B =
// 4 MB per stream at shift 12) do not fit shared memory as s3; their
// compact form does for the alphabets the main path has.  Traffic per
// symbol is one byte out plus at most two bytes of words in.
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

#include "rans_dec_walk.cuh"

namespace {

using namespace fqz5;

constexpr int kO0Shift = 12;
constexpr int kO0Tot = 1 << kO0Shift;

constexpr int kO0Threads = 96;
constexpr int kO0Smem = kHeadBytes + 4 * kO0Tot;

// One step through the s3 LUT in shared memory; ctx is the symbol.
struct O0Step {
    uint32_t lut;                         // shared address
    uint32_t ctx = 0;

    __device__ __forceinline__ uint32_t operator()(uint32_t R) {
        const uint32_t S = lds_u32(lut + 4 * (R & (kO0Tot - 1)));
        uint32_t F = S >> (kO0Shift + 8);
        if (F == 0) F = kO0Tot;
        ctx = S & 0xFF;
        return F * (R >> kO0Shift) + ((S >> 8) & (kO0Tot - 1));
    }
};

__global__ void __launch_bounds__(kO0Threads)
decode_o0_kernel(const uint16_t* __restrict__ words, long long W,
                 const uint32_t* __restrict__ R0,
                 const uint32_t* __restrict__ s3,
                 const int32_t* __restrict__ t_real, int T,
                 uint8_t* __restrict__ syms, uint32_t* __restrict__ Rf) {
    extern __shared__ __align__(16) unsigned char smem[];
    O1Head& h = *reinterpret_cast<O1Head*>(smem);
    uint4* lut = reinterpret_cast<uint4*>(smem + kHeadBytes);
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    if (tid == 0) head_init(h);
    const uint4* s3v = reinterpret_cast<const uint4*>(s3 + (size_t)b * kO0Tot);
    for (int i = tid; i < kO0Tot / 4; i += kO0Threads) lut[i] = __ldg(s3v + i);
    __syncthreads();

    const int tr = max(0, min(t_real[b], T));
    const uint16_t* w = words + (size_t)b * W;
    const uint32_t off = row_off(w);
    if (feed_or_write<false>(h, tid >> 5, w, (uint32_t)W, off,
                             syms + (size_t)b * T * 32, tr, T, lane))
        return;

    uint32_t R = R0[b * 32 + lane];
    uint32_t ptr = 0;
    O0Step st{smem_addr(lut)};
    o1_walk(h, st, R, ptr, tr, (uint32_t)W, off, w[W - 1], lane);
    h.stop = 1;
    // the rows past t_real: the symbol of the frozen state
    h.last[lane] = (uint8_t)lds_u32(st.lut + 4 * (R & (kO0Tot - 1)));
    pair_sync();
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
// Then the block walks as rans_dec_walk.cuh lays out, the writer
// translating codes to bytes; the rows past t_real hold each lane's last
// byte.  No global load is left on a step's chain.
constexpr int kO1Threads = 384;
constexpr uint32_t kZeroFlag = 1u << 12;

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
    if (tid == 0) head_init(h);
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
    const uint32_t off = row_off(w);
    if (feed_or_write<true>(h, warp, w, (uint32_t)W, off,
                            syms + (size_t)b * T * 32, tr, T, lane))
        return;

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
    if (B <= 0) return 0;
    if (W < 1 || W > INT_MAX || (long long)T * 32 > INT_MAX)
        return (int)cudaErrorInvalidValue;
    const cudaError_t attr = cudaFuncSetAttribute(
        decode_o0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kO0Smem);
    if (attr != cudaSuccess) return (int)attr;
    decode_o0_kernel<<<B, kO0Threads, kO0Smem, (cudaStream_t)stream>>>(
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
