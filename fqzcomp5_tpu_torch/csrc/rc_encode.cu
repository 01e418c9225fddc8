// Pass-3 carry-counting range-coder encode walk for many independent
// streams.
//
// Replaces the TPU kernel fqzcomp5_tpu/ops/rc_pallas.py::_rc_call
// (_rc_kernel).  It computes the same coder (native/rc.h; the JAX
// package's rc_jax.encode_scan): per step, range /= tot, low += cum *
// range, range *= freq, a carry when low wraps, then up to two
// shift_lows while range < 2^24.  It does not copy the TPU layout: the
// TPU kernel put 128 streams on the lanes, divided in f32 with +-1
// corrections (the TPU has no integer divide) and wrote per-step event
// planes that two further device passes counted and compacted.
//
// What bounds it on the H100: a stream is one serial chain of steps, and
// the adaptive codecs' streams are few and long (one or two a launch on
// the main path), so the time is the chain's cycles a step times the
// steps of the longest stream.  Memory traffic is 8 bytes in and at most
// about 2 bytes out per step, far below the card's bandwidth.  A thread
// that loads its own inputs, divides in u32 and stores bytes one at a
// time spends most of each step waiting on those.
//
// Design: one block per stream, split by role.
// - Warp 1 (the producers) copies the stream's cf/tot into a ring of
//   kStages shared-memory stages of kTile steps with cp.async, pads the
//   last stage with no-op steps (cum 0, freq 1, tot 1), and puts beside
//   every tot its reciprocal m = floor(2^32 / tot) (2^32 - 1 for tot 1).
//   A stage is handed over on an mbarrier.
// - Lane 0 of warp 0 (the walker) keeps (low, range, cache, ffnum,
//   carry) in registers and reads each group of kGroup steps from shared
//   memory one group ahead of the arithmetic, so no global load is on
//   its chain.  The quotient is q = umulhi(range, m), which is
//   floor(range / tot) or one less for every u32 range and tot in
//   [1, 65535]: no divide on the chain.  range and low are formed from
//   that quotient while the one compare that corrects it runs, and the
//   compare then selects (q * freq or that plus freq).  The shift_lows
//   stay behind a branch (one thread: it never diverges).  Measured on
//   the H100: 81 cycles a step; correcting the quotient before the
//   products, 89; a branch-free step with predicated shift_lows, 155.
// - A flushing shift_low emits (cache + carry) & 0xFF and then ffnum
//   bytes of (carry - 1) & 0xFF.  The walker writes one record a flush,
//   (position, byte, run byte, run length), into the stage's record
//   buffer in shared memory; a run's length is known only when it
//   flushes and may be any length (it can straddle stages and launches:
//   ffnum is carried in the state), so it is stored as a length, not as
//   bytes.  When the walker hands a stage back, the producers write its
//   records to global memory, 32 records a warp store (consecutive
//   records lie on consecutive bytes), and fill each run 32 bytes at a
//   time.
//
// Layout: cf[i] = cum << 16 | freq and tot[i] for every step i of every
// stream; stream b walks cf[off[b] .. off[b] + n[b]).  The state (5, B)
// u32 comes in and goes out, so a long stream walks in chunks.  Stream b
// writes its bytes to out[b * cap ..]; totals[b] counts them even past
// cap, where nothing is written, so the caller can tell an overflow.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "smem_async.cuh"

namespace {

using namespace fqz5;

constexpr uint32_t kTop = 1u << 24;
constexpr uint32_t kThresh = 0xFFu << 24;
constexpr int kTile = 128;            // steps a stage holds
constexpr int kStages = 4;
constexpr int kGroup = 8;             // steps read into registers ahead
constexpr int kRecords = 2 * kTile;   // at most two flushes a step
constexpr int kThreads = 64;          // warp 0: the walker; warp 1: producers

struct Stage {
    uint32_t cf[kTile];
    uint2 tm[kTile];       // (tot, reciprocal of tot)
    uint4 rec[kRecords];   // (position, run length, byte | run byte << 8, 0)
};

struct Shared {
    Stage st[kStages];
    uint32_t nrec[kStages];
    uint64_t full[kStages];   // producers -> walker: the stage is loaded
    uint64_t done[kStages];   // walker -> producers: the stage is walked
};

// floor(2^32 / d) for d >= 2, 2^32 - 1 for d <= 1: umulhi(n, m) is then
// floor(n / d) or one less for every u32 n (rc_torch.rc_quotient)
__device__ __forceinline__ uint32_t rc_recip(uint32_t d) {
    if (d <= 1) return 0xFFFFFFFFu;
    uint32_t m = 0xFFFFFFFFu / d;
    if (0xFFFFFFFFu - m * d == d - 1) ++m;
    return m;
}

struct Walker {
    uint32_t low, rng, cache, ffnum, carry;
    long long pos;
    uint32_t cap;

    __device__ __forceinline__ void shift_low(uint4* rec, uint32_t& nrec) {
        if (low < kThresh || carry) {
            const uint32_t p = pos < cap ? (uint32_t)pos : cap;
            rec[nrec++] = make_uint4(
                p, ffnum, ((cache + carry) & 0xFFu) |
                (((carry - 1u) & 0xFFu) << 8), 0u);
            pos += 1 + (long long)ffnum;
            cache = low >> 24;
            ffnum = 0;
            carry = 0;
        } else {
            ++ffnum;
        }
        low <<= 8;
    }

    __device__ __forceinline__ void step(uint32_t c, uint2 tm, uint4* rec,
                                         uint32_t& nrec) {
        const uint32_t q0 = __umulhi(rng, tm.y);
        const uint32_t f = c & 0xFFFFu, cum = c >> 16;
        const bool up = (rng - q0 * tm.x) >= tm.x;
        const uint32_t r0 = q0 * f, l0 = low + cum * q0;
        rng = up ? r0 + f : r0;
        const uint32_t nl = up ? l0 + cum : l0;
        carry += nl < low;
        low = nl;
        if (rng < kTop) {
            shift_low(rec, nrec);
            rng <<= 8;
            if (rng < kTop) {
                shift_low(rec, nrec);
                rng <<= 8;
            }
        }
    }
};

__device__ void walk(Shared& sh, int ntile, Walker& w) {
    for (int k = 0; k < ntile; ++k) {
        const int s = k % kStages;
        Stage& S = sh.st[s];
        mbar_wait(&sh.full[s], (k / kStages) & 1);
        uint32_t nrec = 0;
        uint32_t c[kGroup];
        uint2 tm[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
            c[j] = S.cf[j];
            tm[j] = S.tm[j];
        }
        for (int g = 0; g < kTile; g += kGroup) {
            // the next group's inputs, read before this group's chain (the
            // last group rereads the first: harmless)
            const int gn = (g + kGroup) & (kTile - 1);
            uint32_t cn[kGroup];
            uint2 tn[kGroup];
#pragma unroll
            for (int j = 0; j < kGroup; ++j) {
                cn[j] = S.cf[gn + j];
                tn[j] = S.tm[gn + j];
            }
#pragma unroll
            for (int j = 0; j < kGroup; ++j) w.step(c[j], tm[j], S.rec, nrec);
#pragma unroll
            for (int j = 0; j < kGroup; ++j) {
                c[j] = cn[j];
                tm[j] = tn[j];
            }
        }
        sh.nrec[s] = nrec;
        mbar_arrive(&sh.done[s]);
    }
}

__device__ void load_stage(Stage& S, uint64_t* full, const uint32_t* pc,
                           const uint32_t* pt, int t0, int steps, int lane) {
    for (int i = lane; i < kTile; i += 32) {
        const int t = t0 + i;
        if (t < steps) {
            cp_async4(&S.cf[i], pc + t);
            cp_async4(&S.tm[i].x, pt + t);
        } else {
            S.cf[i] = 1u;        // cum 0, freq 1
            S.tm[i].x = 1u;      // tot 1: the state is left as it is
        }
    }
    cp_async_commit();
    cp_async_wait<0>();
    for (int i = lane; i < kTile; i += 32) S.tm[i].y = rc_recip(S.tm[i].x);
    mbar_arrive(full);
}

__device__ void flush_stage(const Stage& S, uint32_t nrec, uint8_t* o,
                            uint32_t cap, int lane) {
    for (uint32_t r0 = 0; r0 < nrec; r0 += 32) {
        const uint32_t r = r0 + lane;
        uint4 v = make_uint4(cap, 0u, 0u, 0u);
        if (r < nrec) {
            v = S.rec[r];
            if (v.x < cap) o[v.x] = (uint8_t)v.z;
        }
        uint32_t runs = __ballot_sync(0xffffffffu, v.y != 0);
        while (runs) {
            const int j = __ffs(runs) - 1;
            runs &= runs - 1;
            const long long p = (long long)__shfl_sync(0xffffffffu, v.x, j) + 1;
            const long long e = min(p + (long long)__shfl_sync(0xffffffffu,
                                                               v.y, j),
                                    (long long)cap);
            const uint8_t val = (uint8_t)(__shfl_sync(0xffffffffu, v.z, j) >> 8);
            for (long long q = p + lane; q < e; q += 32) o[q] = val;
        }
    }
}

__global__ void __launch_bounds__(kThreads)
rc_walk_kernel(const uint32_t* __restrict__ cf,
               const uint32_t* __restrict__ tot,
               const long long* __restrict__ off,
               const int32_t* __restrict__ n,
               const uint32_t* __restrict__ st_in, int B, uint32_t cap,
               uint8_t* __restrict__ out, int32_t* __restrict__ totals,
               uint32_t* __restrict__ st_out) {
    __shared__ Shared sh;
    const int b = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int steps = n[b];
    const int ntile = (steps + kTile - 1) / kTile;
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&sh.full[s], 32);
            mbar_init(&sh.done[s], 1);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (warp == 0) {
        if (lane != 0) return;
        Walker w;
        w.low = st_in[b];
        w.rng = st_in[B + b];
        w.cache = st_in[2 * B + b];
        w.ffnum = st_in[3 * B + b];
        w.carry = st_in[4 * B + b];
        w.pos = 0;
        w.cap = cap;
        walk(sh, ntile, w);
        totals[b] = (int32_t)min(w.pos, (long long)INT_MAX);
        st_out[b] = w.low;
        st_out[B + b] = w.rng;
        st_out[2 * B + b] = w.cache;
        st_out[3 * B + b] = w.ffnum;
        st_out[4 * B + b] = w.carry;
        return;
    }

    // producers: load stage k once the walker has handed back the stage's
    // previous tile, whose records they write out first
    const uint32_t* pc = cf + off[b];
    const uint32_t* pt = tot + off[b];
    uint8_t* o = out + (long long)b * cap;
    for (int k = 0; k < ntile; ++k) {
        const int s = k % kStages;
        if (k >= kStages) {
            mbar_wait(&sh.done[s], (k / kStages - 1) & 1);
            flush_stage(sh.st[s], sh.nrec[s], o, cap, lane);
            __syncwarp();
        }
        load_stage(sh.st[s], &sh.full[s], pc, pt, k * kTile, steps, lane);
    }
    for (int k = ntile > kStages ? ntile - kStages : 0; k < ntile; ++k) {
        const int s = k % kStages;
        mbar_wait(&sh.done[s], (k / kStages) & 1);
        flush_stage(sh.st[s], sh.nrec[s], o, cap, lane);
    }
}

}  // namespace

extern "C" int fqz5_rc_encode_walk(const uint32_t* cf, const uint32_t* tot,
                                   const long long* off, const int32_t* n,
                                   const uint32_t* st_in, int B,
                                   long long cap, uint8_t* out,
                                   int32_t* totals, uint32_t* st_out,
                                   void* stream) {
    if (B <= 0) return 0;
    // record positions are u32, clamped to cap
    if (cap < 1 || cap > INT_MAX) return (int)cudaErrorInvalidValue;
    rc_walk_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
        cf, tot, off, n, st_in, B, (uint32_t)cap, out, totals, st_out);
    return (int)cudaGetLastError();
}
