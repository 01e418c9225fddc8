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
// per-lane gather.  Here both walks give a block to a stream, in the layout
// of rans_dec_walk.cuh (a walker warp whose step reads only shared memory,
// a feeder warp that keeps the stream's words in a shared ring, a writer
// warp), and each prologue turns the stream's boundary entries into a
// table indexed by the slot m, so that a step needs no search: at order-0
// one (sym, F, m - C) entry a slot (decode_bnd_o0_kernel), at order-1 a
// slot code and an entry word a context (decode_dense_o1_kernel).
//
// What bounds them on the H100: each lane's serial chain of dependent
// steps, R -> table load -> multiply -> word -> R, once per symbol.  The
// bytes (one symbol byte out, at most two word bytes in) and integer
// operations of a step are far below the card's rates.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "rans_dec_walk.cuh"

namespace {

using namespace fqz5;

constexpr int kMaxO0Entries = 256;

// ---------------------------------------------------------------------
// Order-0: one block per stream, 96 threads (walker, feeder, writer).
//
// The prologue builds, from the stream's S entries and f0, one entry for
// each slot m < tot holding exactly the (sym, F, m - C) the plain walk
// gives for that m (rans_bnd_torch.select_entry):
//   - the selected entry is the last one whose boundary is at most m, the
//     base (f0 << 13 or << 14) where there is none: filled as runs, entry
//     c over [its boundary, the least boundary after it) and the base over
//     [0, the least boundary), so every slot is written once whatever
//     order the boundaries are in;
//   - packed: sym is the selected entry's tag, P >> 26; counter form: sym
//     is the count of boundaries at most m (c only where they rise), from
//     a histogram of the boundaries below tot and its prefix over the
//     slots;
//   - F and C as unpack() reads them: the counter form's F is the JAX
//     kernels' int32 shift (18 signed bits), and the base's C is 0.
// F is taken literally (a row may sum below tot; F = 0 is no frequency of
// tot here, unlike decode_o0's s3 word), and a hand-made or corrupt entry
// may put C past m by up to 14 bits, so a slot takes two words: F, and
// (m - C) << 8 | sym, sign-extended on read, in two arrays of tot words
// read by independent loads (1-1.5% faster than one 8-byte entry a slot on
// the H100 at 700 W).  At shift 12 that is 32 KB a stream, about 43 KB a
// block with the head.
//
// A step is then two independent shared loads, one multiply-add and the
// ring feed.  The rows past t_real hold 0, and ptrf counts the words
// consumed, unclipped.
constexpr int kBndThreads = 96;

// bytes of a block's shared memory past the head: the slot table's two
// arrays, the entries and the runs' ends
__host__ __device__ inline int bnd_o0_bytes(int S, int shift) {
    return (8 << shift) + 4 * S + 4 * (S + 1);
}

// Symbol, frequency and start of the selected entry P (the base entry's C
// is 0 in both forms).  The counter form's symbol is the count of
// boundaries at most m instead, which the caller counts.
template <bool kPacked>
__device__ __forceinline__ void unpack(uint32_t P, uint32_t& sym,
                                       uint32_t& F, uint32_t& C) {
    sym = P >> 26;
    if (kPacked) {
        F = (P >> 13) & 0x1FFFu;
        C = P & 0x1FFFu;
    } else {
        F = (uint32_t)((int32_t)P >> 14);  // the JAX kernels' int32 shift
        C = P & 0x3FFFu;
    }
}

// One step through the slot table in shared memory: F * (R >> shift) +
// (m - C); ctx carries the symbol in its low byte, which the walker stages.
struct BndO0Step {
    uint32_t fw, hw;                      // shared addresses of the arrays
    uint32_t shift, mask;
    uint32_t ctx = 0;

    __device__ __forceinline__ uint32_t operator()(uint32_t R) {
        const uint32_t m = R & mask;
        const uint32_t F = lds_u32(fw + 4 * m);
        const uint32_t hi = lds_u32(hw + 4 * m);
        ctx = hi;
        return F * (R >> shift) + (uint32_t)((int32_t)hi >> 8);
    }
};

template <bool kPacked>
__global__ void __launch_bounds__(kBndThreads)
decode_bnd_o0_kernel(const uint16_t* __restrict__ words, long long W,
                     const uint32_t* __restrict__ R0,
                     const uint32_t* __restrict__ tab,
                     const int32_t* __restrict__ f0,
                     const int32_t* __restrict__ t_real, int T, int S,
                     int shift, uint8_t* __restrict__ syms,
                     uint32_t* __restrict__ Rf, int32_t* __restrict__ ptrf) {
    extern __shared__ __align__(16) unsigned char smem[];
    O1Head& h = *reinterpret_cast<O1Head*>(smem);
    const uint32_t tot = 1u << shift;
    // slot m's two words: fw[m] = F, hw[m] = (m - C) << 8 | sym
    uint32_t* fw = reinterpret_cast<uint32_t*>(smem + kHeadBytes);
    uint32_t* hw = fw + tot;
    uint32_t* ent = hw + tot;
    uint32_t* after = ent + S;     // after[c]: least boundary of c..S-1
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    constexpr uint32_t cmask = kPacked ? 0x1FFFu : 0x3FFFu;

    // prologue 1: the entries; the counter form's histogram starts at 0
    if (tid == 0) head_init(h);
    for (int k = tid; k < S; k += kBndThreads)
        ent[k] = __ldg(tab + (size_t)b * S + k);
    if (!kPacked)
        for (uint32_t m = tid; m < tot; m += kBndThreads) hw[m] = 0;
    __syncthreads();

    // prologue 2: warp 0 the runs' ends (a suffix minimum of the boundaries
    // clamped to tot, lane by lane over chunks of the entries); warps 1 and
    // 2 the counter form's histogram of the boundaries below tot
    if (warp == 0) {
        const int k = (S + 31) / 32;
        const int j0 = min(lane * k, S), j1 = min(j0 + k, S);
        uint32_t incl = tot;
        for (int j = j0; j < j1; ++j) incl = min(incl, ent[j] & cmask);
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t v = __shfl_down_sync(0xffffffffu, incl, d);
            if (lane + d < 32) incl = min(incl, v);
        }
        uint32_t cur = __shfl_down_sync(0xffffffffu, incl, 1);
        if (lane == 31) cur = tot;
        for (int j = j1 - 1; j >= j0; --j) {
            cur = min(cur, ent[j] & cmask);
            after[j] = cur;
        }
        if (lane == 0) after[S] = tot;
    } else if (!kPacked) {
        for (int j = tid - 32; j < S; j += kBndThreads - 32) {
            const uint32_t bnd = ent[j] & cmask;
            if (bnd < tot) atomicAdd(&hw[bnd], 1u);
        }
    }
    __syncthreads();

    // prologue 3 (counter form): the count of boundaries at most m, a
    // prefix of the histogram, 32 slots a round
    if (!kPacked) {
        if (warp == 0) {
            uint32_t carry = 0;
            for (uint32_t m0 = 0; m0 < tot; m0 += 32) {
                const uint32_t m = m0 + lane;
                uint32_t v = m < tot ? hw[m] : 0u;
                for (int d = 1; d < 32; d <<= 1) {
                    const uint32_t u = __shfl_up_sync(0xffffffffu, v, d);
                    if (lane >= d) v += u;
                }
                v += carry;
                if (m < tot) hw[m] = v;
                carry = __shfl_sync(0xffffffffu, v, 31);
            }
        }
        __syncthreads();
    }

    // prologue 4: the runs, one warp a run
    const uint32_t base = (uint32_t)f0[b] << (kPacked ? 13 : 14);
    for (int r = warp; r <= S; r += kBndThreads / 32) {
        const uint32_t P = r ? ent[r - 1] : base;
        const uint32_t lo = r ? min(ent[r - 1] & cmask, tot) : 0u;
        uint32_t sym, F, C;
        unpack<kPacked>(P, sym, F, C);
        for (uint32_t m = lo + lane; m < after[r]; m += 32) {
            if (!kPacked) sym = hw[m];
            fw[m] = F;
            hw[m] = (m - C) << 8 | (sym & 0xFFu);
        }
    }
    __syncthreads();

    const int tr = max(0, min(t_real[b], T));
    const uint16_t* w = words + (size_t)b * W;
    const uint32_t off = row_off(w);
    if (feed_or_write<false>(h, warp, w, (uint32_t)W, off,
                             syms + (size_t)b * T * 32, tr, T, lane))
        return;

    uint32_t R = R0[b * 32 + lane];
    uint32_t ptr = 0;
    BndO0Step step{smem_addr(fw), smem_addr(hw), (uint32_t)shift, tot - 1u};
    o1_walk(h, step, R, ptr, tr, (uint32_t)W, off, w[W - 1], lane);
    h.stop = 1;
    h.last[lane] = 0;
    pair_sync();
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
    if (S < 1 || S > kMaxO0Entries || W < 1 || W > INT_MAX ||
        (long long)T * 32 > INT_MAX || shift < 1 || shift > 12)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return 0;
    auto kern = packed ? decode_bnd_o0_kernel<true>
                       : decode_bnd_o0_kernel<false>;
    const int smem = kHeadBytes + bnd_o0_bytes(S, shift);
    const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
    kern<<<B, kBndThreads, smem, (cudaStream_t)stream>>>(
        words, W, R0, tab, f0, t_real, T, S, shift, syms, Rf, ptrf);
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
