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
// per-lane gather.  At order-0 one warp owns one stream and its table sits
// in shared memory (at most 256 entries, 1 KB); each lane finds its entry
// by a branch-free binary search over the boundary fields, which are
// cumulative frequencies and so nondecreasing: ceil(log2(S+1)) dependent
// shared-memory loads, and words come in by ballot/popc from global memory
// (fqz5::feed_words, rans_dec_common.cuh).  At order-1 one block owns one
// stream, in the layout of rans_dec_walk.cuh, and its prologue turns the
// dense rows into compact tables from which a step needs no search (see
// decode_dense_o1_kernel).
//
// What bounds them on the H100: each lane's serial chain of dependent
// steps, R -> table loads -> multiply -> word -> R, once per symbol.  The
// bytes (one symbol byte out, at most two word bytes in) and integer
// operations of a step are far below the card's rates.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "rans_dec_walk.cuh"

namespace {

using namespace fqz5;

constexpr int kMaxO0Entries = 256;

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

// ---------------------------------------------------------------------
// Order-1 dense tables: one block per stream.
//
// All 12 warps first build the stream's compact tables from its dense rows
// (build_o1_dense_tables' A1 rows of A + 1 entries: entry 0 the row's
// symbol-0 base, entry 1 + j boundary j, the cumulative frequency through
// symbol j).  n1 = A + 1 rows: the A1 rows of the table and, when A1 = A,
// row A, a context with no row.  Per row r a u8 slot table gives for each
// slot m < tot the entry c the walk selects, the last entry whose boundary
// is at most m (0 where none is), filled as runs: entry c over [its
// boundary, the least boundary after it), with 0 from slot 0 and tot
// after the last.  The runs cover every slot once whatever the table, so
// no slot keeps a stale byte; where the boundaries rise along the row, as
// build_o1_dense_tables makes them, c is also the count of boundaries at
// most m, the plain walk's counter-form symbol.  A 32-bit word per
// (r, c) holds the entry's F << 14 | C (F the 18-bit field the JAX
// kernels' int32 shift gives in the counter form, and the base entry's C
// is 0 there).  The row with no row has slot code 0 and word 0 throughout:
// symbol 0 with F = C = 0, as the Pallas kernel's context loop decodes a
// lane whose last symbol has no row.
//
// The word does not carry the symbol (8 + 13 + 12 bits do not fit), and
// needs not: in every table build_o1_dense_tables makes, the tag of
// packed entry c is c mod 64 (the base's is 0), and the counter form's
// symbol is c by definition.  So the slot's code c gives the word's
// column, the symbol and, masked to 6 bits in the packed form, the next
// context: a step is one u8 and one u32 shared load and a multiply-add,
// with no search.  The entry whose boundary is tot (c = A) is never
// selected in a row that sums to tot.
//
// The tables take 4 * n1 * n1 + n1 * tot bytes; where they do not fit the
// block's shared memory (at shift 12 from A = 51, at shift 10 from
// A = 140), the same walk reads them from the stream's scratch in global
// memory.  The route is chosen per launch from A and shift, before the
// walk; nothing is retried.  Symbols leave as dense indices, and the rows
// past t_real hold symbol 0.
constexpr int kDenseThreads = 384;

__host__ __device__ inline long long dense_table_bytes(int A, int shift) {
    const long long n1 = A + 1;
    return 4 * n1 * n1 + (n1 << shift);
}

template <bool SHARED>
struct DenseStep {
    uint32_t slot, wt;                    // shared addresses
    const uint8_t* gslot;                 // or global tables
    const uint32_t* gwt;
    uint32_t n1, shift, mask, cmask;
    uint32_t cbase, wrow, ctx;            // wrow: bytes (shared), words

    __device__ __forceinline__ uint32_t operator()(uint32_t R) {
        const uint32_t m = R & mask;
        uint32_t c, P;
        if (SHARED) {
            c = lds_u8(slot + cbase + m);
            P = lds_u32(wt + wrow + 4 * c);
        } else {
            c = gslot[cbase + m];
            P = gwt[wrow + c];
        }
        ctx = c & cmask;
        cbase = ctx << shift;
        wrow = (SHARED ? 4 : 1) * ctx * n1;
        return (uint32_t)((int32_t)P >> 14) * (R >> shift) + m - (P & 0x3FFFu);
    }
};

__global__ void __launch_bounds__(kDenseThreads)
decode_dense_o1_kernel(const uint16_t* __restrict__ words, long long W,
                       const uint32_t* __restrict__ R0,
                       const uint32_t* __restrict__ tab, int A, int A1,
                       int last0, const int32_t* __restrict__ t_real, int T,
                       int shift, uint8_t* __restrict__ syms,
                       uint32_t* __restrict__ Rf, int32_t* __restrict__ ptrf,
                       int route, uint8_t* scratch,
                       long long scratch_stride) {
    extern __shared__ __align__(16) unsigned char smem[];
    O1Head& h = *reinterpret_cast<O1Head*>(smem);
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const uint32_t tot = 1u << shift;
    const uint32_t n1 = A + 1;
    const bool packed = A <= 64;
    const uint32_t bmask = packed ? 0x1FFFu : 0x3FFFu;   // boundary field
    const uint32_t* E = tab + (size_t)b * A1 * n1;
    unsigned char* t = route == kRouteShared
                           ? smem + kHeadBytes
                           : scratch + (size_t)b * scratch_stride;
    uint32_t* wt = reinterpret_cast<uint32_t*>(t);
    uint8_t* slot = t + 4 * (size_t)n1 * n1;
    if (tid == 0) head_init(h);

    // prologue: the words, then the slot runs, one warp a run
    for (uint32_t i = tid; i < n1 * n1; i += kDenseThreads) {
        const uint32_t c = i % n1;
        uint32_t v = 0;
        if (i / n1 < (uint32_t)A1) {
            const uint32_t P = __ldg(E + i);
            v = packed ? ((P >> 13) & 0x1FFFu) << 14 | (P & 0x1FFFu)
                       : c ? P : P & ~0x3FFFu;
        }
        wt[i] = v;
    }
    for (uint32_t run = warp; run < (uint32_t)A1 * n1;
         run += kDenseThreads / 32) {
        const uint32_t r = run / n1, c = run % n1;
        const uint32_t lo = c ? min(__ldg(E + run) & bmask, tot) : 0u;
        uint32_t hi = tot;
        for (uint32_t j = c + 1 + lane; j <= (uint32_t)A; j += 32)
            hi = min(hi, __ldg(E + r * n1 + j) & bmask);
        hi = __reduce_min_sync(0xFFFFFFFFu, hi);
        for (uint32_t m = lo + lane; m < hi; m += 32)
            slot[r * tot + m] = (uint8_t)c;
    }
    if (A1 == A)
        for (uint32_t m = tid; m < tot; m += kDenseThreads)
            slot[(uint32_t)A * tot + m] = 0;
    __syncthreads();

    const int tr = max(0, min(t_real[b], T));
    const uint16_t* w = words + (size_t)b * W;
    const uint32_t off = row_off(w);
    if (feed_or_write<false>(h, warp, w, (uint32_t)W, off,
                             syms + (size_t)b * T * 32, tr, T, lane))
        return;

    uint32_t R = R0[b * 32 + lane];
    uint32_t ptr = 0;
    const uint32_t lastw = w[W - 1];
    const uint32_t cmask = packed ? 63u : 255u;
    const uint32_t ctx = (uint32_t)last0;
    if (route == kRouteShared) {
        DenseStep<true> st{smem_addr(slot), smem_addr(wt), nullptr, nullptr,
                           n1, (uint32_t)shift, tot - 1u, cmask,
                           ctx << shift, 4 * ctx * n1, ctx};
        o1_walk(h, st, R, ptr, tr, (uint32_t)W, off, lastw, lane);
    } else {
        DenseStep<false> st{0, 0, slot, wt, n1, (uint32_t)shift, tot - 1u,
                            cmask, ctx << shift, ctx * n1, ctx};
        o1_walk(h, st, R, ptr, tr, (uint32_t)W, off, lastw, lane);
    }
    h.stop = 1;
    h.last[lane] = 0;
    pair_sync();
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
                                         int32_t* ptrf, uint8_t* scratch,
                                         long long scratch_stride,
                                         void* stream) {
    if (B <= 0) return 0;
    if (W < 1 || W > INT_MAX || (long long)T * 32 > INT_MAX || A < 1 ||
        A > 255 || (A1 != A && A1 != A + 1) || last0 < 0 || last0 >= A1 ||
        shift < 1 || shift > 12)
        return (int)cudaErrorInvalidValue;
    // the tables in shared memory where they fit, else in the scratch the
    // caller gives (dense_table_bytes a stream, 16-byte aligned rows)
    const long long need = dense_table_bytes(A, shift);
    const int route = need <= kTableBytes ? kRouteShared : kRouteGlobal;
    if (route == kRouteGlobal &&
        (scratch == nullptr || scratch_stride < need || scratch_stride % 16))
        return (int)cudaErrorInvalidValue;
    const int smem = kHeadBytes + (route == kRouteShared ? (int)need : 0);
    const cudaError_t attr = cudaFuncSetAttribute(
        decode_dense_o1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (attr != cudaSuccess) return (int)attr;
    decode_dense_o1_kernel<<<B, kDenseThreads, smem, (cudaStream_t)stream>>>(
        words, W, R0, tab, A, A1, last0, t_real, T, shift, syms, Rf, ptrf,
        route, scratch, scratch_stride);
    return (int)cudaGetLastError();
}
