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
// through rolled DMA windows.  Here one warp owns one stream: the symbol
// is one s3 gather, and the renormalising lanes take consecutive words at
// ptr + popc(ballot & lanes_below) (fqz5::feed_words, rans_dec_common.cuh,
// shared with rans_decode_bnd.cu).  There is no alphabet limit.
//
// What bounds them on the H100: per step, the dependent chain R -> s3
// gather -> multiply -> word gather -> R.  The order-0 s3 table (16 KB)
// sits in shared memory, so its gather is a shared-memory load; the
// order-1 tables (256 contexts x 4096 slots x 4 B = 4 MB per stream at
// shift 12) stay in global memory and hit L2.  Traffic per symbol is one
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
#include <stdint.h>

#include "rans_dec_common.cuh"

namespace {

constexpr int kO0Shift = 12;
constexpr int kO0Tot = 1 << kO0Shift;
constexpr int kO1WarpsPerBlock = 4;

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

__global__ void decode_o1_kernel(const uint16_t* __restrict__ words,
                                 long long W,
                                 const uint32_t* __restrict__ R0,
                                 const uint32_t* __restrict__ s3, int shift,
                                 const int32_t* __restrict__ t_real, int B,
                                 int T, uint8_t* __restrict__ syms,
                                 uint32_t* __restrict__ Rf,
                                 int32_t* __restrict__ ptrf) {
    const int b = blockIdx.x * kO1WarpsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (b >= B) return;  // the whole warp leaves together

    const uint32_t tot = 1u << shift;
    const uint32_t mask = tot - 1u;
    const uint32_t* s3b = s3 + (long long)b * 256 * tot;
    const uint16_t* w = words + (long long)b * W;
    uint8_t* out = syms + (long long)b * T * 32;
    const uint32_t lt_mask = (1u << lane) - 1u;
    const int tr = min(t_real[b], T);
    uint32_t R = R0[b * 32 + lane];
    uint32_t last = 0;
    long long ptr = 0;
    for (int t = 0; t < tr; ++t) {
        const uint32_t S = __ldg(s3b + last * tot + (R & mask));
        uint32_t F = S >> (shift + 8);
        if (F == 0) F = tot;
        uint32_t Rn = F * (R >> shift) + ((S >> 8) & mask);
        Rn = fqz5::feed_words(Rn, w, W, ptr, lt_mask);
        last = S & 0xFF;
        out[(long long)t * 32 + lane] = (uint8_t)last;
        R = Rn;
    }
    for (int t = tr; t < T; ++t) out[(long long)t * 32 + lane] = (uint8_t)last;
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
                                   int32_t* ptrf, void* stream) {
    const dim3 grid((B + kO1WarpsPerBlock - 1) / kO1WarpsPerBlock);
    decode_o1_kernel<<<grid, 32 * kO1WarpsPerBlock, 0,
                       (cudaStream_t)stream>>>(
        words, W, R0, s3, shift, t_real, B, T, syms, Rf, ptrf);
    return (int)cudaGetLastError();
}
