// Order-0 and order-1 32-lane rANS 32x16 decode walks over boundary tables.
//
// Replace the TPU kernels of fqzcomp5_tpu/ops/rans_pallas_dec.py that find
// each lane's symbol by a compare-reduction over boundary tables:
//   decode_bnd_o0:   decode_walk (v1, pallas_call at :234), decode_walk4
//                    (v2, :406), decode_walk4v3 (:665) and decode_walk4v4
//                    (:1590), one function in four layouts;
//   decode_dense_o1: decode_walk4v3_o1 (:908).
// They compute what ops/rans_bnd_torch.decode_bnd_o0_ref and
// decode_dense_o1_ref compute.  Per step every active lane takes
// m = R & (tot-1), selects the last table entry whose boundary field is
// at most m (the row's symbol-0 base when there is none), reads the
// symbol, F and C from it (packed: symbol in bits 26-31, F in 13-25, C in
// 0-12; counter form: F << 14 | C, the symbol being the count of
// boundaries <= m), sets R = F * (R >> shift) + m - C and renormalises.
// At order-1 a lane's row is its last dense symbol; a lane whose last
// symbol has no row (only a corrupt stream gets there) decodes symbol 0
// with F = C = 0, as the Pallas kernel's context loop does.  Steps at or
// past a stream's t_real move nothing and write symbol 0, as there.
//
// The TPU kernels compared m with every entry, O(S) vector operations a
// step and O(A^2) at order-1 with the context loop, because the TPU has no
// per-lane gather.  Here one warp owns one stream and its table sits in
// shared memory: at most 256 entries (1 KB) at order-0, A1*(A+1) entries
// at order-1 (16.9 KB at A = 64, the engine's limit).  Each lane finds its
// entry by a branch-free binary search over the boundary fields, which
// are cumulative frequencies and so nondecreasing: ceil(log2(n+1))
// dependent shared-memory loads.  Words come in by ballot/popc
// (fqz5::feed_words, shared with rans_decode.cu).
//
// What bounds them on the H100: each lane's serial chain of dependent
// steps, R -> search loads -> multiply -> word load -> R, once per symbol.
// The bytes (one symbol byte out, at most two word bytes in) and integer
// operations of a step are far below the card's rates.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rans_dec_common.cuh"

namespace {

constexpr int kMaxO0Entries = 256;
constexpr size_t kStaticSmem = 48 * 1024;

// Largest power of two <= n (1 for n < 2).
__host__ __device__ inline int top_pow2(int n) {
    int t = 1;
    while (t * 2 <= n) t *= 2;
    return t;
}

// How many of the n nondecreasing boundary fields of tab[0..n) are at
// most m; top = top_pow2(n).
__device__ __forceinline__ int count_le(const uint32_t* tab, int n, int top,
                                        uint32_t cmask, uint32_t m) {
    int c = 0;
    for (int step = top; step > 0; step >>= 1) {
        if (c + step <= n && (tab[c + step - 1] & cmask) <= m) c += step;
    }
    return c;
}

// Symbol, frequency and start of the selected entry P; c is the count of
// boundaries <= m (P is the base entry when c == 0).
template <bool kPacked>
__device__ __forceinline__ void unpack(uint32_t P, int c, uint32_t& sym,
                                       uint32_t& F, uint32_t& C) {
    if (kPacked) {
        sym = P >> 26;
        F = (P >> 13) & 0x1FFFu;
        C = P & 0x1FFFu;
    } else {
        sym = (uint32_t)c;
        F = (uint32_t)((int32_t)P >> 14);  // the JAX kernels' int32 shift
        C = c > 0 ? (P & 0x3FFFu) : 0u;
    }
}

template <bool kPacked>
__global__ void decode_bnd_o0_kernel(const uint16_t* __restrict__ words,
                                     long long W,
                                     const uint32_t* __restrict__ R0,
                                     const uint32_t* __restrict__ tab,
                                     const int32_t* __restrict__ f0,
                                     const int32_t* __restrict__ t_real,
                                     int T, int S, int shift,
                                     uint8_t* __restrict__ syms,
                                     uint32_t* __restrict__ Rf,
                                     int32_t* __restrict__ ptrf) {
    __shared__ uint32_t ent[kMaxO0Entries];
    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    for (int k = lane; k < S; k += 32) ent[k] = tab[(long long)b * S + k];
    __syncwarp();

    constexpr uint32_t cmask = kPacked ? 0x1FFFu : 0x3FFFu;
    const uint32_t base = (uint32_t)f0[b] << (kPacked ? 13 : 14);
    const int top = top_pow2(S);
    const uint32_t mask = (1u << shift) - 1u;
    const uint16_t* w = words + (long long)b * W;
    uint8_t* out = syms + (long long)b * T * 32;
    const uint32_t lt_mask = (1u << lane) - 1u;
    const int tr = max(0, min(t_real[b], T));
    uint32_t R = R0[b * 32 + lane];
    long long ptr = 0;
    for (int t = 0; t < tr; ++t) {
        const uint32_t m = R & mask;
        const int c = count_le(ent, S, top, cmask, m);
        uint32_t sym, F, C;
        unpack<kPacked>(c ? ent[c - 1] : base, c, sym, F, C);
        R = fqz5::feed_words(F * (R >> shift) + (m - C), w, W, ptr, lt_mask);
        out[(long long)t * 32 + lane] = (uint8_t)sym;
    }
    for (int t = tr; t < T; ++t) out[(long long)t * 32 + lane] = 0;
    Rf[b * 32 + lane] = R;
    if (lane == 0) ptrf[b] = (int32_t)ptr;
}

template <bool kPacked>
__global__ void decode_dense_o1_kernel(const uint16_t* __restrict__ words,
                                       long long W,
                                       const uint32_t* __restrict__ R0,
                                       const uint32_t* __restrict__ tab,
                                       int A, int A1, int last0,
                                       const int32_t* __restrict__ t_real,
                                       int T, int shift,
                                       uint8_t* __restrict__ syms,
                                       uint32_t* __restrict__ Rf,
                                       int32_t* __restrict__ ptrf) {
    extern __shared__ uint32_t ent[];
    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    const int stride = A + 1;
    const int n = A1 * stride;
    for (int k = lane; k < n; k += 32) ent[k] = tab[(long long)b * n + k];
    __syncwarp();

    constexpr uint32_t cmask = kPacked ? 0x1FFFu : 0x3FFFu;
    const int top = top_pow2(A);
    const uint32_t mask = (1u << shift) - 1u;
    const uint16_t* w = words + (long long)b * W;
    uint8_t* out = syms + (long long)b * T * 32;
    const uint32_t lt_mask = (1u << lane) - 1u;
    const int tr = max(0, min(t_real[b], T));
    uint32_t R = R0[b * 32 + lane];
    uint32_t last = (uint32_t)last0;
    long long ptr = 0;
    for (int t = 0; t < tr; ++t) {
        const uint32_t m = R & mask;
        uint32_t sym = 0, F = 0, C = 0;
        if (last < (uint32_t)A1) {
            const uint32_t* row = ent + last * stride;
            const int c = count_le(row + 1, A, top, cmask, m);
            unpack<kPacked>(row[c], c, sym, F, C);
        }
        R = fqz5::feed_words(F * (R >> shift) + (m - C), w, W, ptr, lt_mask);
        last = sym;
        out[(long long)t * 32 + lane] = (uint8_t)sym;
    }
    for (int t = tr; t < T; ++t) out[(long long)t * 32 + lane] = 0;
    Rf[b * 32 + lane] = R;
    if (lane == 0) ptrf[b] = (int32_t)ptr;
}

}  // namespace

extern "C" int fqz5_rans_decode_bnd_o0(const uint16_t* words, long long W,
                                       const uint32_t* R0,
                                       const uint32_t* tab,
                                       const int32_t* f0,
                                       const int32_t* t_real, int B, int T,
                                       int S, int packed, int shift,
                                       uint8_t* syms, uint32_t* Rf,
                                       int32_t* ptrf, void* stream) {
    if (S < 1 || S > kMaxO0Entries) return (int)cudaErrorInvalidValue;
    auto kern = packed ? decode_bnd_o0_kernel<true>
                       : decode_bnd_o0_kernel<false>;
    kern<<<B, 32, 0, (cudaStream_t)stream>>>(words, W, R0, tab, f0, t_real,
                                             T, S, shift, syms, Rf, ptrf);
    return (int)cudaGetLastError();
}

extern "C" int fqz5_rans_decode_dense_o1(const uint16_t* words, long long W,
                                         const uint32_t* R0,
                                         const uint32_t* tab, int A, int A1,
                                         int last0, const int32_t* t_real,
                                         int B, int T, int shift,
                                         uint8_t* syms, uint32_t* Rf,
                                         int32_t* ptrf, void* stream) {
    // one warp a block, so a block's shared memory is one stream's table;
    // above the static 48 KB it must be asked for
    const size_t smem = (size_t)A1 * (A + 1) * sizeof(uint32_t);
    auto kern = A <= 64 ? decode_dense_o1_kernel<true>
                        : decode_dense_o1_kernel<false>;
    if (smem > kStaticSmem) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kern<<<B, 32, smem, (cudaStream_t)stream>>>(words, W, R0, tab, A, A1,
                                                last0, t_real, T, shift, syms,
                                                Rf, ptrf);
    return (int)cudaGetLastError();
}
