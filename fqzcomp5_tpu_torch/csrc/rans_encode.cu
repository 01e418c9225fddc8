// Reversed 32-lane rANS 32x16 encode walk for many independent streams.
//
// Replaces the TPU kernel fqzcomp5_tpu/ops/rans_pallas.py::encode_walk
// (_encode_kernel).  It computes the same thing: for every stream, walk
// the (T, 32) plane of table indices from t = T-1 down to 0, renormalise
// each lane's state R when R >> (31 - shift) >= f, and then
// R = (R / f) << shift + R % f + start.  It does not copy the TPU layout:
// the TPU kernel packed 4 streams into a 128-lane row, divided in f32 with
// +-1 corrections and wrote a word|emit<<16 plane that a separate sort
// compacted.  Here one warp owns one stream (lane z = rANS state z), the
// quotient is an exact u32 divide, and the emitted words are placed by
// ballot/popc directly in their final order.
//
// What bounds it on the H100: the per-lane dependency chain
// R -> compare -> divide -> R, once per step, for T steps.  Memory traffic
// is 1 byte (order-0 plane) or 4 bytes (order-1 flat plane) in and at most
// 2 bytes out per symbol, far below the card's bandwidth; with one warp
// per stream the card holds only as many warps as there are streams in a
// batch.  The design keeps the chain short: the next step's plane index
// and table entry do not depend on R, so they are loaded one step ahead.
//
// Output layout: stream b owns words[b * T*32 .. (b+1) * T*32).  Words are
// written backwards from the end of that region, each step's emitting
// lanes in ascending lane order, so ascending addresses hold (t asc,
// z asc) -- the order of rans_jax.assemble_o0_stream.  The compact payload
// is the last nwords[b] entries of the region.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr uint32_t kRansL = 1u << 15;
constexpr int kWarpsPerBlock = 4;

template <typename IdxT>
__device__ __forceinline__ int load_index(const IdxT* __restrict__ ix,
                                          int t, int lane, int n,
                                          int sentinel) {
    const long long p = (long long)t * 32 + lane;
    return p < n ? (int)ix[p] : sentinel;
}

template <typename IdxT>
__global__ void encode_walk_kernel(const IdxT* __restrict__ idx,
                                   const int32_t* __restrict__ nsym,
                                   const uint32_t* __restrict__ tab,
                                   long long tab_stride, int sentinel,
                                   const uint32_t* __restrict__ R0,
                                   int B, int T, int shift,
                                   uint32_t* __restrict__ Rf,
                                   uint16_t* __restrict__ words,
                                   int32_t* __restrict__ nwords) {
    const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (b >= B) return;  // the whole warp leaves together

    const long long cap = (long long)T * 32;
    const IdxT* ix = idx + (long long)b * cap;
    const uint32_t* tb = tab + (long long)b * tab_stride;
    uint16_t* out = words + (long long)b * cap;
    // u8 planes carry no sentinel values: slots at or past the stream's
    // symbol count take the no-op entry
    const int n = nsym ? nsym[b] : INT_MAX;
    const uint32_t lt_mask = (1u << lane) - 1u;
    const uint32_t start_mask = (1u << shift) - 1u;

    uint32_t R = R0 ? R0[b * 32 + lane] : kRansL;
    long long pos = cap;
    uint32_t P_next = tb[load_index(ix, T - 1, lane, n, sentinel)];
    for (int t = T - 1; t >= 0; --t) {
        const uint32_t P = P_next;
        if (t > 0) P_next = tb[load_index(ix, t - 1, lane, n, sentinel)];
        const uint32_t f = P >> shift;
        const uint32_t start = P & start_mask;
        const bool emit = (R >> (31 - shift)) >= f;
        const uint32_t bal = __ballot_sync(0xffffffffu, emit);
        pos -= __popc(bal);
        if (emit) {
            out[pos + __popc(bal & lt_mask)] = (uint16_t)(R & 0xFFFFu);
            R >>= 16;
        }
        const uint32_t q = R / f;
        R = (q << shift) + (R - q * f) + start;
    }
    Rf[b * 32 + lane] = R;
    if (lane == 0) nwords[b] = (int32_t)(cap - pos);
}

}  // namespace

extern "C" int fqz5_rans_encode_walk(const void* idx, int idx_bytes,
                                     const int32_t* nsym,
                                     const uint32_t* tab,
                                     long long tab_stride, int sentinel,
                                     const uint32_t* R0, int B, int T,
                                     int shift, uint32_t* Rf,
                                     uint16_t* words, int32_t* nwords,
                                     void* stream) {
    const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
    const dim3 block(32 * kWarpsPerBlock);
    cudaStream_t s = (cudaStream_t)stream;
    if (idx_bytes == 1) {
        encode_walk_kernel<uint8_t><<<grid, block, 0, s>>>(
            (const uint8_t*)idx, nsym, tab, tab_stride, sentinel, R0, B, T,
            shift, Rf, words, nwords);
    } else if (idx_bytes == 4) {
        encode_walk_kernel<int32_t><<<grid, block, 0, s>>>(
            (const int32_t*)idx, nsym, tab, tab_stride, sentinel, R0, B, T,
            shift, Rf, words, nwords);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
