// Pass-2 model evolution of the adaptive codecs: one walk per model
// context over that context's occurrences, emitting the (cum, freq, tot)
// each encode uses, packed as cf = cum << 16 | freq and tot.
//
// evolve_kernel<CAP> replaces the TPU kernel
// fqzcomp5_tpu/ops/model_pallas.py::evolve_walk (_evolve_kernel) at
// CAP = 128, and runs fqz_model_jax.evolve(lanes=256), a lax.scan with no
// Pallas kernel, at CAP = 256.  It computes the AdaptiveModel step of
// c_simple_model.h:63-171: find the symbol's slot, emit the frequencies
// before it, its frequency and tot, bump by STEP, halve every frequency
// when tot passes (1 << 16) - 17, then swap the slot with the one before
// it when its frequency is now larger (symbol order is coded state).  The
// TPU kernel put 128 contexts on the lanes and the model array on the
// sublanes, finding the slot by compare-reductions and the prefix by a
// roll butterfly.  Here there are two layouts, picked per launch from
// the number of contexts C, before the launch:
// - One warp per context (every C at CAP = 256; C < kThreadLayoutMinC at
//   CAP = 128): lane L keeps slots L*K .. L*K+K-1 (K = CAP/32) and the
//   sum of the frequencies before each, kept up to date by every bump and
//   swap, so a step's chain holds two warp collectives (the ballot that
//   finds the slot's lane, and the shuffle of a swap across a lane
//   boundary) where the first port had eight (symbol, ballot, slot,
//   reduction, cum, f and two swap shuffles); the shuffle of (cum, f) to
//   the emitting lane and of the next symbol are off the chain.  Long
//   contexts, whose walk is one chain, take it.
// - One thread per context (CAP = 128, C >= kThreadLayoutMinC): the
//   reference's linear scan over the bubble-ordered slots in shared
//   memory.  A step costs the scan to the symbol's slot, eight slots a
//   round, instead of 32 lanes' instructions; the short count buckets,
//   with many contexts, were issue-bound in the warp layout.
//
// tiny_kernel<NSYM> runs fqz_model_jax.tiny_evolve (a lax.scan, no Pallas
// kernel): the SEQ codec's TinyModel<4>/<2> with STEP 1, halving when the
// pre-bump tot reaches 255.  One thread owns one context, its NSYM
// frequencies in registers.
//
// What bounds them on the H100: the serial chain of each context's walk.
// The k-mer and qual models have millions of short contexts, so many
// warps or threads run and the card is filled; a few models (SEQ
// run-length, fqz length bytes) have one context with hundreds of
// thousands of occurrences, and that walk is latency-bound whatever the
// layout.  Memory traffic is 1 byte in and 8 out per occurrence; the warp
// kernel loads 32 symbols and stores 32 results at a time, coalesced; the
// thread kernel stages 32 steps of its 32 contexts in shared memory and
// moves them one row at a time, coalesced too.
//
// Layout: symbol plane (C, T) uint8 row-major, counts (C,), and for the
// AdaptiveModel max_sym (C,); outputs cf, tot (C, T), zero past counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kMaxFreq = (1u << 16) - 17;
constexpr uint32_t kTinyMax = 255;
constexpr int kWarpsPerBlock = 4;
constexpr int kTinyThreads = 128;
// evolve_128 takes one thread a context from this many contexts up
constexpr int kThreadLayoutMinC = 1024;
constexpr int kScan = 8;   // slots a scan round of the thread layout reads

template <int K>
__device__ __forceinline__ uint32_t pick(const uint32_t (&a)[K], int k) {
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < K; ++j)
        if (j == k) v = a[j];
    return v;
}

template <int K>
__device__ __forceinline__ void place(uint32_t (&a)[K], int k, uint32_t v) {
#pragma unroll
    for (int j = 0; j < K; ++j)
        if (j == k) a[j] = v;
}

// One warp per context.  Lane L keeps slots L*K .. L*K+K-1 (K = CAP/32):
// symbol, frequency and cu, the sum of the frequencies of every slot
// before it.  A bump adds STEP to the slot and to every later slot's cu
// (each lane knows from the ballot whether its slots are later), a swap
// changes two adjacent entries, and only a halving sums the prefixes anew
// (one warp scan).  On a step's chain: the ballot, and the shuffle of a
// swap across a lane boundary; the (cum, f) shuffle to the emitting lane
// is off it.
template <int CAP>
__global__ void evolve_kernel(const uint8_t* __restrict__ plane,
                              const int32_t* __restrict__ counts,
                              const int32_t* __restrict__ max_sym, int C,
                              int T, uint32_t step,
                              uint32_t* __restrict__ out_cf,
                              uint32_t* __restrict__ out_tot) {
    constexpr int K = CAP / 32;
    const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= C) return;  // the whole warp leaves together

    uint32_t sy[K], fr[K], cu[K];
    const uint32_t ms = (uint32_t)max_sym[row];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        sy[k] = lane * K + k;
        fr[k] = sy[k] < ms;
        cu[k] = min(sy[k], ms);
    }
    uint32_t tot = ms;
    const int n = counts[row];
    const long long base = (long long)row * T;

    for (int t0 = 0; t0 < T; t0 += 32) {
        const int m = min(32, n - t0);   // walked steps in this batch
        const int mine = lane < m ? plane[base + t0 + lane] : 0;
        uint32_t my_cf = 0, my_tot = 0;
        for (int i = 0; i < m; ++i) {
            const uint32_t s = __shfl_sync(kFull, mine, i);
            int kl = -1;
#pragma unroll
            for (int k = 0; k < K; ++k)
                if (sy[k] == s) kl = k;
            // collective 1: the owner of the symbol's slot (none: s >= CAP)
            const uint32_t bal = __ballot_sync(kFull, kl >= 0);
            const int owner = bal ? __ffs(bal) - 1 : 32;
            const uint32_t f = pick(fr, kl);
            // collective 2, off the state's chain: (cum, f) to lane i
            const uint32_t cf =
                __shfl_sync(kFull, pick(cu, kl) << 16 | f, owner & 31);
            if (lane == i) {
                my_cf = bal ? cf : 0u;
                my_tot = tot;
            }
            // bump: the slot and every prefix after it
            if (lane == owner) place(fr, kl, f + step);
#pragma unroll
            for (int k = 0; k < K; ++k)
                if (lane > owner || (lane == owner && k > kl)) cu[k] += step;
            tot += step;
            // normalise on overflow (zeros stay zero), prefixes anew
            if (tot > kMaxFreq) {
                uint32_t ls = 0;
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    fr[k] -= fr[k] >> 1;
                    cu[k] = ls;
                    ls += fr[k];
                }
                uint32_t inc = ls;
#pragma unroll
                for (int d = 1; d < 32; d <<= 1) {
                    const uint32_t v = __shfl_up_sync(kFull, inc, d);
                    if (lane >= d) inc += v;
                }
#pragma unroll
                for (int k = 0; k < K; ++k) cu[k] += inc - ls;
                tot = __shfl_sync(kFull, inc, 31);
            }
            // bubble: swap pos-1 <-> pos when freq[pos] > freq[pos-1];
            // inside the owner's slots with selects, no branch
            const uint32_t fv = pick(fr, kl), fp = pick(fr, kl - 1);
            const uint32_t sp = pick(sy, kl - 1), cp = pick(cu, kl - 1);
            const bool inner = lane == owner && kl > 0 && fv > fp;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                if (inner && k == kl) {
                    fr[k] = fp;
                    sy[k] = sp;
                    cu[k] = cp + fv;
                }
                if (inner && k == kl - 1) {
                    fr[k] = fv;
                    sy[k] = s;
                }
            }
            if (owner > 0 && owner < 32) {
                // collective 3: the swap across a lane boundary (slot 0 of
                // the owner with the last slot of the lane before it); the
                // owner sends 0 unless its slot is its first, and no
                // frequency is below 0, so then nothing moves
                const uint32_t send = lane == owner
                                          ? (kl == 0 ? fr[0] : 0u)
                                          : fr[K - 1] << 8 | sy[K - 1];
                const uint32_t got =
                    __shfl_sync(kFull, send, lane == owner ? owner - 1 : owner);
                if (lane == owner - 1 && got > fr[K - 1]) {
                    fr[K - 1] = got;
                    sy[K - 1] = s;
                }
                if (lane == owner && kl == 0 && fr[0] > got >> 8) {
                    cu[0] += fr[0] - (got >> 8);
                    fr[0] = got >> 8;
                    sy[0] = got & 0xFF;
                }
            }
        }
        if (t0 + lane < T) {
            out_cf[base + t0 + lane] = my_cf;
            out_tot[base + t0 + lane] = my_tot;
        }
    }
}

// One thread per context, for count buckets of many contexts, where the
// warp layout is issue-bound: the slots in shared memory, slot k of
// thread j's context at sl[k][j] (so the 32 threads of a warp read 32
// banks whatever slot each is at), packed f << 8 | symbol, and the step is
// the reference's own: scan the bubble-ordered slots for the symbol,
// summing the frequencies before it, eight slots a load round.  The warp
// walks its 32 contexts 32 steps at a time; their symbols come in, and
// their (cf, tot) go out, through shared memory one context row at a
// time, so each global access is 32 consecutive entries of one row.
__global__ void __launch_bounds__(32)
evolve_thread_kernel(const uint8_t* __restrict__ plane,
                     const int32_t* __restrict__ counts,
                     const int32_t* __restrict__ max_sym, int C, int T,
                     uint32_t step, uint32_t* __restrict__ out_cf,
                     uint32_t* __restrict__ out_tot) {
    constexpr int CAP = 128;
    __shared__ uint32_t sl[CAP][32];
    __shared__ uint32_t cfb[32][33];   // [step][context]: symbol, then cf
    __shared__ uint32_t ttb[32][33];
    const int lane = threadIdx.x;
    const int row0 = blockIdx.x * 32;
    const int row = row0 + lane;
    const int rows = min(32, C - row0);
    const uint32_t ms = lane < rows ? (uint32_t)max_sym[row] : 0u;
    for (uint32_t k = 0; k < CAP; ++k)
        sl[k][lane] = (k < ms ? 1u << 8 : 0u) | k;
    uint32_t tot = ms;
    const int n = lane < rows ? min(counts[row], T) : 0;
    for (int t0 = 0; t0 < T; t0 += 32) {
        const int w = min(32, T - t0);
        for (int r = 0; r < rows; ++r)
            if (lane < w)
                cfb[lane][r] = plane[(long long)(row0 + r) * T + t0 + lane];
        __syncwarp();
        for (int i = 0; i < w; ++i) {
            uint32_t cf = 0, emit_tot = 0;
            if (t0 + i < n) {
                const uint32_t s = cfb[i][lane];
                uint32_t k = 0;
                emit_tot = tot;
                tot += step;
                if (s < CAP) {
                    // kScan slots a round, all loaded before any compare;
                    // CAP is a multiple of kScan, so no round reads past it
                    uint32_t cum = 0, e = 0;
                    for (;; k += kScan) {
                        uint32_t x[kScan];
#pragma unroll
                        for (int q = 0; q < kScan; ++q) x[q] = sl[k + q][lane];
                        uint32_t hit = kScan;
#pragma unroll
                        for (int q = kScan - 1; q >= 0; --q)
                            if ((x[q] & 0xFF) == s) hit = q;
#pragma unroll
                        for (int q = 0; q < kScan; ++q) {
                            if (q < (int)hit) cum += x[q] >> 8;
                            if (q == (int)hit) e = x[q];
                        }
                        if (hit < kScan) {
                            k += hit;
                            break;
                        }
                    }
                    cf = cum << 16 | e >> 8;
                    sl[k][lane] = e + (step << 8);
                }
                // normalise on overflow (zeros stay zero)
                if (tot > kMaxFreq) {
                    tot = 0;
                    for (uint32_t q = 0; q < CAP; ++q) {
                        const uint32_t x = sl[q][lane];
                        const uint32_t g = (x >> 8) - (x >> 9);
                        sl[q][lane] = g << 8 | (x & 0xFF);
                        tot += g;
                    }
                }
                // bubble: swap pos-1 <-> pos when freq[pos] > freq[pos-1]
                if (s < CAP && k > 0) {
                    const uint32_t here = sl[k][lane], prev = sl[k - 1][lane];
                    if (here >> 8 > prev >> 8) {
                        sl[k - 1][lane] = here;
                        sl[k][lane] = prev;
                    }
                }
            }
            cfb[i][lane] = cf;   // the symbol is read: its cell takes cf
            ttb[i][lane] = emit_tot;
        }
        __syncwarp();
        for (int r = 0; r < rows; ++r)
            if (lane < w) {
                const long long o = (long long)(row0 + r) * T + t0 + lane;
                out_cf[o] = cfb[lane][r];
                out_tot[o] = ttb[lane][r];
            }
        __syncwarp();
    }
}

template <int NSYM>
__global__ void tiny_kernel(const uint8_t* __restrict__ plane,
                            const int32_t* __restrict__ counts, int C, int T,
                            uint32_t* __restrict__ out_cf,
                            uint32_t* __restrict__ out_tot) {
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= C) return;
    uint32_t fr[NSYM];
#pragma unroll
    for (int j = 0; j < NSYM; ++j) fr[j] = 1;
    const int n = counts[row];
    const long long base = (long long)row * T;
    for (int t = 0; t < T; ++t) {
        uint32_t cf = 0, tt = 0;
        if (t < n) {
            const uint32_t s = plane[base + t];
            uint32_t tot = 0, cum = 0, f = 0;
#pragma unroll
            for (int j = 0; j < NSYM; ++j) {
                tot += fr[j];
                if (j < (int)s) cum += fr[j];
                if (j == (int)s) f = fr[j];
            }
#pragma unroll
            for (int j = 0; j < NSYM; ++j) {
                if (j == (int)s) fr[j] += 1;
                if (tot >= kTinyMax) fr[j] -= fr[j] >> 1;
            }
            cf = (cum << 16) | f;
            tt = tot;
        }
        out_cf[base + t] = cf;
        out_tot[base + t] = tt;
    }
}

}  // namespace

extern "C" int fqz5_evolve(const uint8_t* plane, const int32_t* counts,
                           const int32_t* max_sym, int C, int T, int cap,
                           int step, uint32_t* out_cf, uint32_t* out_tot,
                           void* stream) {
    if (C <= 0 || T <= 0) return 0;
    const dim3 grid((C + kWarpsPerBlock - 1) / kWarpsPerBlock);
    const dim3 block(32 * kWarpsPerBlock);
    cudaStream_t s = (cudaStream_t)stream;
    if (cap == 128 && C >= kThreadLayoutMinC) {
        evolve_thread_kernel<<<(C + 31) / 32, 32, 0, s>>>(
            plane, counts, max_sym, C, T, (uint32_t)step, out_cf, out_tot);
    } else if (cap == 128) {
        evolve_kernel<128><<<grid, block, 0, s>>>(
            plane, counts, max_sym, C, T, (uint32_t)step, out_cf, out_tot);
    } else if (cap == 256) {
        evolve_kernel<256><<<grid, block, 0, s>>>(
            plane, counts, max_sym, C, T, (uint32_t)step, out_cf, out_tot);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int fqz5_tiny_evolve(const uint8_t* plane, const int32_t* counts,
                                int C, int T, int nsym, uint32_t* out_cf,
                                uint32_t* out_tot, void* stream) {
    if (C <= 0 || T <= 0) return 0;
    const dim3 grid((C + kTinyThreads - 1) / kTinyThreads);
    cudaStream_t s = (cudaStream_t)stream;
    if (nsym == 4) {
        tiny_kernel<4><<<grid, kTinyThreads, 0, s>>>(plane, counts, C, T,
                                                     out_cf, out_tot);
    } else if (nsym == 2) {
        tiny_kernel<2><<<grid, kTinyThreads, 0, s>>>(plane, counts, C, T,
                                                     out_cf, out_tot);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
