// Reversed 32-lane rANS 32x16 encode walk for many independent streams.
//
// Replaces the TPU kernel fqzcomp5_tpu/ops/rans_pallas.py::encode_walk
// (_encode_kernel).  It computes the same thing: for every stream, walk
// the (T, 32) plane of table indices from t = T-1 down to 0, renormalise
// each lane's state R when R >> (31 - shift) >= f, and then
// R = (R / f) << shift + R % f + start.  It does not copy the TPU layout:
// the TPU kernel packed 4 streams into a 128-lane row, divided in f32 with
// +-1 corrections and wrote a word|emit<<16 plane that a separate sort
// compacted.  Here one warp owns one stream (lane z = rANS state z), and
// the emitted words are placed by ballot/popc directly in their final
// order.
//
// What bounds it on the H100: the per-lane dependency chain, once per
// step, for T steps.  Memory traffic is 1 byte (order-0 plane) or 4
// bytes (order-1 flat plane) in and at most 2 bytes out per symbol, far
// below the card's bandwidth; with one warp per stream the card holds only
// as many warps as a batch has streams.  A chain that waits for the plane
// index, then for the table entry it selects (both global loads), then
// for an exact u32 divide, takes hundreds of cycles a step.
//
// Design: nothing but arithmetic on the chain.  A step is
//   emit = R > x_max;  R >>= 16 if emit;
//   q = umulhi(R, rcp) >> rsh;  R += bias + q * cmpl
// with the encoder symbol (x_max, rcp, rsh, bias, cmpl) of the step's
// table entry (f << shift) | start, formed as RansEncSymbolInit forms it
// (rans_torch.enc_symbols; engine_cuda._lane31_tail on the host).  The
// quotient is exact for every state R < 2^31.  Steps go in groups of
// kGroup: the group's states are stepped first, keeping each step's word
// and emit flag in registers, and then the words are placed (ballot/popc,
// in step order) and stored, so no warp vote sits between two steps; the
// next group's encoder symbols are formed in registers meanwhile.
// - Order-0 (uint8 symbol planes): at the start each warp builds its
//   stream's 256 encoder symbols and the no-op sentinel's in shared
//   memory (4 KB).  Plane tiles of kRows8 rows are copied into shared
//   memory with cp.async, double-buffered, one tile ahead.
// - Order-1 (int32 flat-index planes): the table (65,537 entries a
//   stream) stays in global memory.  A step's entry does not depend on
//   R, so each lane gathers its entry kAhead steps ahead with cp.async
//   into a shared-memory ring, reading the index from a plane tile that
//   was itself copied kAhead steps before; one commit group a step group.
// - The parts of a symbol that depend on f alone (rcp, rsh) come from a
//   4,097-entry table built once a device (g_rsym, 32 KB), read through
//   the read-only cache a group before the chain needs them, so forming
//   a symbol costs a few integer operations and no divide.
//
// Output layout: stream b owns words[b * T*32 .. (b+1) * T*32).  Words are
// written backwards from the end of that region, each step's emitting
// lanes in ascending lane order, so ascending addresses hold (t asc,
// z asc) -- the order of rans_jax.assemble_o0_stream.  The compact payload
// is the last nwords[b] entries of the region.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include <atomic>

#include "smem_async.cuh"

namespace {

using namespace fqz5;

constexpr uint32_t kRansL = 1u << 15;
constexpr int kMaxF = 4096;        // frequencies at shift <= 12
constexpr int kGroup = 8;          // steps whose symbols are formed together
// order-0
constexpr int kWarps8 = 4;
constexpr int kRows8 = 64;         // plane rows a tile
// order-1
constexpr int kWarps32 = 2;
constexpr int kAhead = 32;         // steps an entry is gathered ahead
constexpr int kGroupsAhead = kAhead / kGroup;
constexpr int kRows32 = kAhead;    // plane rows a tile (the schedule needs
                                   // kRows32 >= kAhead)
static_assert(kRows8 % kGroup == 0 && kRows32 % kGroup == 0,
              "tiles hold whole step groups");

// The parts of an encoder symbol that depend on f alone, for every f a
// table at shift <= 12 holds: (rcp, rsh << 16), with rcp =
// ceil(2^(31 + ceil(log2 f)) / f) and rsh = ceil(log2 f) - 1, or
// (2^32 - 1, 0) for f < 2.  Built once a device (rsym_init_kernel).
__device__ uint2 g_rsym[kMaxF + 1];

__global__ void rsym_init_kernel() {
    const uint32_t f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f > kMaxF) return;
    if (f < 2) {
        g_rsym[f] = make_uint2(0xFFFFFFFFu, 0u);
        return;
    }
    const uint32_t sh = 32 - __clz(f - 1);
    g_rsym[f] = make_uint2((uint32_t)(((1ull << (sh + 31)) + f - 1) / f),
                           (sh - 1) << 16);
}

// (x_max, rcp, bias, cmpl | rsh << 16) of a packed entry (f << shift) |
// start, given g_rsym[f]
__device__ __forceinline__ uint4 enc_symbol(uint32_t P, int shift, uint2 rs) {
    const uint32_t f = P >> shift;
    const uint32_t start = P & ((1u << shift) - 1u);
    return make_uint4((f << (31 - shift)) - 1u, rs.x,
                      start + (f < 2 ? (1u << shift) - 1u : 0u),
                      ((1u << shift) - f) | rs.y);
}

__device__ __forceinline__ uint2 rsym_of(uint32_t P, int shift) {
    return __ldg(&g_rsym[min(P >> shift, (uint32_t)kMaxF)]);
}

__device__ __forceinline__ void store_if(uint16_t* p, uint32_t v,
                                         bool on) {
    asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
                 "@q st.global.u16 [%0], %1;\n\t}\n"
                 :: "l"(p), "h"((unsigned short)v), "r"((uint32_t)on)
                 : "memory");
}

struct Lane {
    uint32_t R;
    uint32_t pos;        // words of the region not yet written
    uint32_t lt_mask;
    uint16_t* out;

    // kGroup steps: first the states alone (the chain), keeping each
    // step's word and emit flag, then the ballots and stores, in step
    // order.  Steps past the walk's end carry a no-op symbol.
    __device__ __forceinline__ void group(const uint4 (&e)[kGroup]) {
        uint32_t word[kGroup];
        bool emit[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
            emit[k] = R > e[k].x;
            word[k] = R & 0xFFFFu;
            const uint32_t Rs = emit[k] ? R >> 16 : R;
            const uint32_t q = __umulhi(Rs, e[k].y) >> (e[k].w >> 16);
            R = Rs + e[k].z + q * (e[k].w & 0xFFFFu);
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
            const uint32_t bal = __ballot_sync(0xffffffffu, emit[k]);
            pos -= __popc(bal);
            store_if(out + pos + __popc(bal & lt_mask), word[k], emit[k]);
        }
    }
};

// ---------------------------------------------------------------------
// order-0: uint8 symbol planes, encoder symbols in shared memory

struct O0Warp {
    uint4 enc[257];                  // symbols 0..255, the sentinel at 256
    uint8_t rows[2][kRows8 * 32];
};

__global__ void __launch_bounds__(32 * kWarps8)
encode_o0_kernel(const uint8_t* __restrict__ idx,
                 const int32_t* __restrict__ nsym,
                 const uint32_t* __restrict__ tab, long long tab_stride,
                 int sentinel, const uint32_t* __restrict__ R0, int B,
                 int T, int shift, uint32_t* __restrict__ Rf,
                 uint16_t* __restrict__ words,
                 int32_t* __restrict__ nwords) {
    __shared__ __align__(16) O0Warp sm[kWarps8];
    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarps8 + w;
    if (b >= B) return;  // the whole warp leaves together
    O0Warp& S = sm[w];

    const uint32_t cap = (uint32_t)T * 32;
    const uint8_t* ix = idx + (long long)b * cap;
    const uint32_t* tb = tab + (long long)b * tab_stride;
    for (int i = lane; i < 257; i += 32) {
        const uint32_t P = tb[i < 256 && i < sentinel ? i : sentinel];
        S.enc[i] = enc_symbol(P, shift, rsym_of(P, shift));
    }
    // slots at or past the stream's symbol count take the sentinel
    const uint32_t n = nsym ? (uint32_t)nsym[b] : 0xFFFFFFFFu;

    // tile m holds walk steps [m * kRows8, ...), i.e. rows T-1-m*kRows8 down
    auto copy_tile = [&](int m) {
        const int u0 = m * kRows8;
        const int nr = min(kRows8, T - u0);
        uint8_t* dst = S.rows[m & 1];
        for (int k = lane; k < nr * 2; k += 32) {
            const int i = k >> 1, half = (k & 1) * 16;
            cp_async16(dst + i * 32 + half,
                       ix + (long long)(T - 1 - u0 - i) * 32 + half);
        }
        cp_async_commit();
    };
    // encoder symbols of steps [u0, u0 + kGroup): symbols first, then
    // their entries, so the shared loads overlap
    auto form = [&](int u0, uint4 (&e)[kGroup]) {
        const uint8_t* rows = S.rows[(u0 / kRows8) & 1];
        uint32_t s[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
            const int u = u0 + k;
            const uint32_t p = (uint32_t)(T - 1 - u) * 32 + lane;
            s[k] = u < T && p < n ? rows[(u % kRows8) * 32 + lane] : 256;
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) e[k] = S.enc[s[k]];
    };

    Lane L{R0 ? R0[b * 32 + lane] : kRansL, cap, (1u << lane) - 1u,
           words + (long long)b * cap};
    const int ntile = (T + kRows8 - 1) / kRows8;
    uint4 ec[kGroup], en[kGroup];
    if (ntile) {
        copy_tile(0);
        cp_async_wait<0>();
        __syncwarp();   // tile 0 and the encoder symbols, seen by all lanes
        form(0, ec);
    }
    // Tile m + 1 is copied at tile m's first group into the buffer of
    // tile m - 1, whose last symbols were formed a group before; it is
    // waited for at tile m's last group, which forms its first symbols.
    for (int u0 = 0; u0 < T; u0 += kGroup) {
        const int m = u0 / kRows8;
        if (u0 % kRows8 == 0 && m + 1 < ntile) copy_tile(m + 1);
        if ((u0 + kGroup) % kRows8 == 0 && m + 1 < ntile) {
            cp_async_wait<0>();
            __syncwarp();
        }
        form(u0 + kGroup, en);
        L.group(ec);
#pragma unroll
        for (int k = 0; k < kGroup; ++k) ec[k] = en[k];
    }
    Rf[b * 32 + lane] = L.R;
    if (lane == 0) nwords[b] = (int32_t)(cap - L.pos);
}

// ---------------------------------------------------------------------
// order-1 (and any int32 index plane): entries gathered kAhead steps ahead

struct O1Warp {
    int32_t rows[2][kRows32 * 32];
    uint32_t P[kAhead * 32];         // ring of gathered entries, by step
};

__global__ void __launch_bounds__(32 * kWarps32)
encode_o1_kernel(const int32_t* __restrict__ idx,
                 const int32_t* __restrict__ nsym,
                 const uint32_t* __restrict__ tab, long long tab_stride,
                 int sentinel, const uint32_t* __restrict__ R0, int B,
                 int T, int shift, uint32_t* __restrict__ Rf,
                 uint16_t* __restrict__ words,
                 int32_t* __restrict__ nwords) {
    __shared__ __align__(16) O1Warp sm[kWarps32];
    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarps32 + w;
    if (b >= B) return;  // the whole warp leaves together
    O1Warp& S = sm[w];

    const uint32_t cap = (uint32_t)T * 32;
    const int32_t* ix = idx + (long long)b * cap;
    const uint32_t* tb = tab + (long long)b * tab_stride;
    const uint32_t n = nsym ? (uint32_t)nsym[b] : 0xFFFFFFFFu;

    // a tile is copied 16 bytes a lane (a warp barrier follows each wait);
    // each lane gathers into and reads only its own slots of the ring
    auto copy_tile = [&](int m) {
        const int u0 = m * kRows32;
        const int nr = min(kRows32, T - u0);
        int32_t* dst = S.rows[m & 1];
        for (int k = lane; k < nr * 8; k += 32) {
            const int i = k >> 3, quad = (k & 7) * 4;
            cp_async16(dst + i * 32 + quad,
                       ix + (long long)(T - 1 - u0 - i) * 32 + quad);
        }
    };
    // the entries of steps [u0, u0 + kGroup) into the ring, as one commit
    // group: indices first, then the copies
    auto gather = [&](int u0) {
        int e[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
            const int u = u0 + k;
            const uint32_t p = (uint32_t)(T - 1 - u) * 32 + lane;
            e[k] = p < n ? S.rows[(u / kRows32) & 1][(u % kRows32) * 32 + lane]
                         : sentinel;
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
            if (u0 + k < T)
                cp_async4(&S.P[((u0 + k) % kAhead) * 32 + lane], tb + e[k]);
        cp_async_commit();
    };
    // encoder symbols of steps [u0, u0 + kGroup) from their gathered
    // entries: entries first, then the f parts; steps past the end take
    // the no-op entry (f = 1 << shift, start 0)
    auto form = [&](int u0, uint4 (&e)[kGroup]) {
        uint32_t P[kGroup];
        uint2 rs[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
            P[k] = u0 + k < T ? S.P[((u0 + k) % kAhead) * 32 + lane]
                              : 1u << (2 * shift);
#pragma unroll
        for (int k = 0; k < kGroup; ++k) rs[k] = rsym_of(P[k], shift);
#pragma unroll
        for (int k = 0; k < kGroup; ++k) e[k] = enc_symbol(P[k], shift, rs[k]);
    };

    Lane L{R0 ? R0[b * 32 + lane] : kRansL, cap, (1u << lane) - 1u,
           words + (long long)b * cap};
    const int ntile = (T + kRows32 - 1) / kRows32;
    // prologue: tiles 0 and 1, then the first kGroupsAhead groups'
    // gathers (one commit group each), and group 0's symbols
    for (int m = 0; m < 2 && m < ntile; ++m) copy_tile(m);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    for (int j = 0; j < kGroupsAhead; ++j) gather(j * kGroup);
    cp_async_wait<kGroupsAhead - 1>();
    uint4 ec[kGroup], en[kGroup];
    form(0, ec);

    // At the group of steps u0: the commit groups of the gathers for u0
    // and u0 + kGroup have arrived (the wait), the latter's symbols are
    // formed, and the group kAhead steps on is gathered into u0's slots
    // (their entries are already in registers).  At a tile's first group,
    // tile m + 2 is copied into tile m's buffer, whose last indices every
    // lane read in the gathers issued kAhead steps before.
    for (int u0 = 0; u0 < T; u0 += kGroup) {
        cp_async_wait<kGroupsAhead - 2>();
        __syncwarp();
        form(u0 + kGroup, en);
        const int m = u0 / kRows32;
        if (u0 % kRows32 == 0 && m + 2 < ntile) copy_tile(m + 2);
        gather(u0 + kAhead);
        L.group(ec);
#pragma unroll
        for (int k = 0; k < kGroup; ++k) ec[k] = en[k];
    }
    cp_async_wait<0>();
    Rf[b * 32 + lane] = L.R;
    if (lane == 0) nwords[b] = (int32_t)(cap - L.pos);
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
    if (B <= 0) return 0;
    // word positions are u32; plane rows are copied 16 bytes at a time
    if (shift < 1 || shift > 12 || T < 0 || (long long)T * 32 > INT_MAX)
        return (int)cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(idx) & 15)
        return (int)cudaErrorMisalignedAddress;
    cudaStream_t s = (cudaStream_t)stream;
    // the f table, once a device (devices past 31 build it every call)
    static std::atomic<uint32_t> ready{0};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 32 || !(ready.load() & (1u << dev))) {
        rsym_init_kernel<<<(kMaxF + 256) / 256, 256, 0, s>>>();
        const cudaError_t e = cudaStreamSynchronize(s);
        if (e != cudaSuccess) return (int)e;
        if (dev < 32) ready.fetch_or(1u << dev);
    }
    if (idx_bytes == 1) {
        encode_o0_kernel<<<(B + kWarps8 - 1) / kWarps8, 32 * kWarps8, 0, s>>>(
            (const uint8_t*)idx, nsym, tab, tab_stride, sentinel, R0, B, T,
            shift, Rf, words, nwords);
    } else if (idx_bytes == 4) {
        encode_o1_kernel<<<(B + kWarps32 - 1) / kWarps32, 32 * kWarps32, 0,
                           s>>>(
            (const int32_t*)idx, nsym, tab, tab_stride, sentinel, R0, B, T,
            shift, Rf, words, nwords);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
