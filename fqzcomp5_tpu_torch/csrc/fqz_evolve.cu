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
//   At CAP = 256 the warp layout also walks runs of the symbol in slot 0
//   in closed form: slot 0 has no slot before it, so it never swaps and
//   its cum is 0, and until the bump that takes tot past kMaxFreq a run
//   of r such steps emits f0 + STEP*i and tot0 + STEP*i and moves every
//   other slot's cu by STEP*r.  One ballot a window marks the lanes
//   holding that symbol, and the window's leading run of them is emitted
//   so; the rest of the window walks step by step.  The SEQ codec's
//   run-length models are such runs of 255 (whole windows but for one
//   halving every two thousand steps or so), and a window of them is far
//   shorter than a load from device memory, so the symbols come
//   kRunAhead windows ahead through shared memory.
//
// The TinyModel walks run fqz_model_jax.tiny_evolve (a lax.scan, no
// Pallas kernel): the SEQ codec's TinyModel<4>/<2> with STEP 1, halving
// when the pre-bump tot reaches 255.  Two layouts, picked per launch
// from C before the launch:
// - tiny_warp_kernel (C < kTinyThreadMinC): one warp per context, 32
//   steps a round.  Lane i holds the round's i-th symbol; a ballot per
//   symbol and popc of the lanes before each lane give every lane its
//   (cum, f, tot) from the round's starting frequencies at once.  tot
//   rises by at most 1 a step and a halving leaves it at 128 or more, so
//   at most one halving (at the first lane whose pre-bump tot reaches
//   255) falls in a round; lanes after it start from the halved
//   frequencies.  Only the NSYM frequencies carry from round to round,
//   and symbols are loaded kTinyAhead rounds ahead.  The SEQ codec's
//   first k-mer context of every read, one context with an occurrence
//   per read, is one such long walk.
// - tiny_thread_kernel (C >= kTinyThreadMinC): one thread per context,
//   the reference's step, the NSYM frequencies in registers; symbols in
//   and (cf, tot) out are staged in shared memory a row segment at a
//   time, as in evolve_thread_kernel, so every global access is a run of
//   one row's consecutive cells.
//
// What bounds them on the H100: the serial chain of each context's walk.
// The k-mer and qual models have millions of short contexts, so many
// warps or threads run and the card is filled; a few models (SEQ
// run-length and read-start k-mer contexts, fqz length bytes) have one
// context with hundreds of thousands of occurrences, and that walk is
// latency-bound whatever the layout: the TinyModel round and the slot-0
// run window put 32 steps on one link of its chain.  Memory traffic is 1
// byte in and 8 out per occurrence; the warp kernels load 32 symbols and
// store 32 results at a time, coalesced; the thread kernels stage 32
// steps of their 32 contexts in shared memory and move them one row at a
// time, coalesced too.
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
// evolve_128 takes one thread a context from this many contexts up
constexpr int kThreadLayoutMinC = 1024;
constexpr int kScan = 8;   // slots a scan round of the thread layout reads
// TinyModel walks take one thread a context from this many contexts up:
// at -5's count buckets (T = 16 to 1,024) each layout wins on its side
constexpr int kTinyThreadMinC = 65536;
constexpr int kTinyAhead = 16;   // rounds tiny_warp_kernel loads ahead
constexpr int kRunAhead = 16;    // windows evolve_kernel<256> loads ahead

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
// is off it.  At CAP = 256 a window's leading run of the symbol in slot 0
// is emitted in closed form before the step-by-step walk, and the
// window's symbols come from a per-warp ring in shared memory refilled
// kRunAhead windows ahead (a window of closed-form steps is far shorter
// than a load from device memory).
template <int CAP>
__global__ void evolve_kernel(const uint8_t* __restrict__ plane,
                              const int32_t* __restrict__ counts,
                              const int32_t* __restrict__ max_sym, int C,
                              int T, uint32_t step,
                              uint32_t* __restrict__ out_cf,
                              uint32_t* __restrict__ out_tot) {
    constexpr int K = CAP / 32;
    constexpr int R = CAP == 256 ? kRunAhead : 1;   // ring windows
    __shared__ uint32_t ring[kWarpsPerBlock][R][32];
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
    // CAP 256: this lane's column of the ring (windows w*R .. w*R+R-1)
    // and, in registers, its symbols of the R windows after them
    uint32_t* rg = &ring[threadIdx.x >> 5][0][lane];
    uint32_t ahead[R];
    if constexpr (CAP == 256) {
#pragma unroll
        for (int d = 0; d < R; ++d) {
            const int t = 32 * d + lane;
            rg[32 * d] = t < n ? plane[base + t] : 0u;
            ahead[d] = t + 32 * R < n ? plane[base + t + 32 * R] : 0u;
        }
    }

    for (int t0 = 0; t0 < T; t0 += 32) {
        const int m = min(32, n - t0);   // walked steps in this batch
        int mine;
        if constexpr (CAP == 256) {
            const int d = (t0 >> 5) % R;
            mine = (int)rg[32 * d];
            if (d == R - 1) {
                // every window in the ring is read: refill it from the
                // loads in flight and start those R windows further on
#pragma unroll
                for (int e = 0; e < R; ++e) {
                    const int t = t0 + 32 * (R + 1 + e) + lane;
                    rg[32 * e] = ahead[e];
                    ahead[e] = t < n ? plane[base + t] : 0u;
                }
            }
        } else {
            mine = lane < m ? plane[base + t0 + lane] : 0;
        }
        uint32_t my_cf = 0, my_tot = 0;
        int i = 0;
        if constexpr (CAP == 256) {
            // the window's leading run of the symbol in slot 0, cut
            // before the bump that would take tot past kMaxFreq (that
            // step halves): closed form
            const uint32_t s0 = __shfl_sync(kFull, sy[0], 0);
            const uint32_t run =
                __ballot_sync(kFull, lane < m && (uint32_t)mine == s0);
            int r = __clz(__brev(~run));   // trailing ones: 32 if all
            if (tot + step * r > kMaxFreq)
                r = (kMaxFreq - tot) / step;
            if (r > 0) {
                const uint32_t f0 = __shfl_sync(kFull, fr[0], 0);
                if (lane < r) {
                    my_cf = f0 + step * lane;   // cum 0: slot 0
                    my_tot = tot + step * lane;
                }
                const uint32_t add = step * r;
#pragma unroll
                for (int k = 0; k < K; ++k)
                    if (lane > 0 || k > 0) cu[k] += add;
                if (lane == 0) fr[0] += add;
                tot += add;
                i = r;
            }
        }
        for (; i < m; ++i) {
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

// One warp per TinyModel context, 32 steps a round (see the top of the
// file).  Every lane keeps the same copy of the NSYM frequencies and tot
// (their sum) at the round's start.
template <int NSYM>
__global__ void tiny_warp_kernel(const uint8_t* __restrict__ plane,
                                 const int32_t* __restrict__ counts, int C,
                                 int T, uint32_t* __restrict__ out_cf,
                                 uint32_t* __restrict__ out_tot) {
    const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= C) return;  // the whole warp leaves together
    const uint32_t lt = (1u << lane) - 1u;   // the lanes before this one
    const int n = min(counts[row], T);
    const long long base = (long long)row * T;
    uint32_t fr[NSYM];
#pragma unroll
    for (int j = 0; j < NSYM; ++j) fr[j] = 1;
    uint32_t tot = NSYM;
    uint32_t q[kTinyAhead];   // this lane's symbol of the next rounds
#pragma unroll
    for (int d = 0; d < kTinyAhead; ++d) {
        const int t = 32 * d + lane;
        q[d] = t < n ? plane[base + t] : 0u;
    }
    for (int t0 = 0; t0 < T; t0 += 32 * kTinyAhead) {
#pragma unroll
        for (int d = 0; d < kTinyAhead; ++d) {
            const int tw = t0 + 32 * d;
            if (tw >= T) break;
            const uint32_t s = q[d];
            const int tn = tw + 32 * kTinyAhead + lane;
            q[d] = tn < n ? plane[base + tn] : 0u;
            const int m = n - tw;   // steps left in the row
            const uint32_t vm = m >= 32 ? kFull : m > 0 ? (1u << m) - 1u : 0u;
            uint32_t mk[NSYM], inr = 0;
#pragma unroll
            for (int j = 0; j < NSYM; ++j) {
                mk[j] = __ballot_sync(kFull, s == (uint32_t)j) & vm;
                inr |= mk[j];
            }
            // the halving lane h: the first walked lane whose pre-bump
            // tot, tot + the bumps before it, reaches kTinyMax
            const uint32_t hm =
                __ballot_sync(kFull, tot + __popc(inr & lt) >= kTinyMax) & vm;
            const int h = __ffs(hm) - 1;   // -1: no halving this round
            const uint32_t le = h < 0 ? 0u : h == 31 ? kFull : (2u << h) - 1u;
            // g: the frequencies after lane h's bump and halving; lanes
            // after h count their bumps from there
            uint32_t g[NSYM], cle[NSYM];
#pragma unroll
            for (int j = 0; j < NSYM; ++j) {
                cle[j] = __popc(mk[j] & le);
                const uint32_t b = fr[j] + cle[j];
                g[j] = b - (b >> 1);
            }
            const bool after = h >= 0 && lane > h;
            uint32_t cum = 0, f = 0, tt = 0;
#pragma unroll
            for (int j = 0; j < NSYM; ++j) {
                const uint32_t c = __popc(mk[j] & lt);
                const uint32_t fj = after ? g[j] + c - cle[j] : fr[j] + c;
                if ((uint32_t)j < s) cum += fj;   // all of them: s >= NSYM
                if ((uint32_t)j == s) f = fj;
                tt += fj;
            }
            if (tw + lane < T) {
                const bool walked = lane < m;
                out_cf[base + tw + lane] = walked ? cum << 16 | f : 0u;
                out_tot[base + tw + lane] = walked ? tt : 0u;
            }
            tot = 0;
#pragma unroll
            for (int j = 0; j < NSYM; ++j) {
                fr[j] = h >= 0 ? g[j] + __popc(mk[j]) - cle[j]
                               : fr[j] + __popc(mk[j]);
                tot += fr[j];
            }
        }
    }
}

// One thread per TinyModel context, for count buckets of many contexts:
// the reference's step with the frequencies in registers; the warp walks
// its 32 contexts 32 steps at a time, their symbols in and (cf, tot) out
// through shared memory one context row at a time.  A segment's 32 rows
// of symbols are loaded into registers a segment ahead, so their loads
// are in flight together while the segment before is walked.
template <int NSYM>
__global__ void __launch_bounds__(32)
tiny_thread_kernel(const uint8_t* __restrict__ plane,
                   const int32_t* __restrict__ counts, int C, int T,
                   uint32_t* __restrict__ out_cf,
                   uint32_t* __restrict__ out_tot) {
    __shared__ uint32_t cfb[32][33];   // [step][context]: symbol, then cf
    __shared__ uint32_t ttb[32][33];
    const int lane = threadIdx.x;
    const int row0 = blockIdx.x * 32;
    const int rows = min(32, C - row0);
    const int n = lane < rows ? min(counts[row0 + lane], T) : 0;
    const uint8_t* col = plane + (long long)row0 * T + lane;
    uint32_t fr[NSYM];
#pragma unroll
    for (int j = 0; j < NSYM; ++j) fr[j] = 1;
    uint32_t v[32];   // row r's symbol at step t0 + lane of the next segment
#pragma unroll
    for (int r = 0; r < 32; ++r)
        v[r] = r < rows && lane < T ? col[(long long)r * T] : 0u;
    for (int t0 = 0; t0 < T; t0 += 32) {
        const int w = min(32, T - t0);
        const int tn = t0 + 32;
#pragma unroll
        for (int r = 0; r < 32; ++r) {
            cfb[lane][r] = v[r];
            v[r] = r < rows && tn + lane < T ? col[(long long)r * T + tn] : 0u;
        }
        __syncwarp();
        for (int i = 0; i < w; ++i) {
            uint32_t cf = 0, tt = 0;
            if (t0 + i < n) {
                const uint32_t s = cfb[i][lane];
                uint32_t cum = 0, f = 0;
#pragma unroll
                for (int j = 0; j < NSYM; ++j) {
                    tt += fr[j];
                    if ((uint32_t)j < s) cum += fr[j];
                    if ((uint32_t)j == s) f = fr[j];
                }
#pragma unroll
                for (int j = 0; j < NSYM; ++j) {
                    if ((uint32_t)j == s) fr[j] += 1;
                    if (tt >= kTinyMax) fr[j] -= fr[j] >> 1;
                }
                cf = cum << 16 | f;
            }
            cfb[i][lane] = cf;   // the symbol is read: its cell takes cf
            ttb[i][lane] = tt;
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
    if (nsym != 2 && nsym != 4) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (C >= kTinyThreadMinC) {
        const dim3 grid((C + 31) / 32);
        if (nsym == 4)
            tiny_thread_kernel<4><<<grid, 32, 0, s>>>(plane, counts, C, T,
                                                      out_cf, out_tot);
        else
            tiny_thread_kernel<2><<<grid, 32, 0, s>>>(plane, counts, C, T,
                                                      out_cf, out_tot);
    } else {
        const dim3 grid((C + kWarpsPerBlock - 1) / kWarpsPerBlock);
        const dim3 block(32 * kWarpsPerBlock);
        if (nsym == 4)
            tiny_warp_kernel<4><<<grid, block, 0, s>>>(plane, counts, C, T,
                                                       out_cf, out_tot);
        else
            tiny_warp_kernel<2><<<grid, block, 0, s>>>(plane, counts, C, T,
                                                       out_cf, out_tot);
    }
    return (int)cudaGetLastError();
}
