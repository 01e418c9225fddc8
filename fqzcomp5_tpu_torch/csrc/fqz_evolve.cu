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
// roll butterfly.  Here one warp owns one context: lane L keeps slots
// L*K .. L*K+K-1 (K = CAP/32) in registers, the slot is found by ballot,
// the frequencies below it by one warp reduction, and the swap crosses at
// most one lane boundary, by shuffle.
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
// kernel loads 32 symbols and stores 32 results at a time, coalesced.
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

    uint32_t sy[K], fr[K];
    const uint32_t ms = (uint32_t)max_sym[row];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        sy[k] = lane * K + k;
        fr[k] = sy[k] < ms;
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
            const uint32_t bal = __ballot_sync(kFull, kl >= 0);
            const int owner = bal ? __ffs(bal) - 1 : 0;
            const int klb = __shfl_sync(kFull, kl, owner);
            uint32_t lsum = 0, part = 0;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                lsum += fr[k];
                if (k < klb) part += fr[k];
            }
            const uint32_t below =
                __reduce_add_sync(kFull, lane < owner ? lsum : 0u);
            const uint32_t cum =
                bal ? below + __shfl_sync(kFull, part, owner) : 0u;
            const uint32_t f =
                bal ? __shfl_sync(kFull, pick(fr, klb), owner) : 0u;
            if (lane == i) {
                my_cf = (cum << 16) | f;
                my_tot = tot;
            }
            // bump
            if (bal && lane == owner) place(fr, klb, pick(fr, klb) + step);
            tot += step;
            // normalise on overflow (zeros stay zero)
            if (tot > kMaxFreq) {
                uint32_t ls = 0;
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    fr[k] -= fr[k] >> 1;
                    ls += fr[k];
                }
                tot = __reduce_add_sync(kFull, ls);
            }
            // bubble: swap pos-1 <-> pos when freq[pos] > freq[pos-1]
            if (bal && (owner > 0 || klb > 0)) {
                const int pk = klb > 0 ? klb - 1 : K - 1;
                const int pl = klb > 0 ? owner : owner - 1;
                const uint32_t fval = __shfl_sync(kFull, pick(fr, klb), owner);
                const uint32_t fprev = __shfl_sync(kFull, pick(fr, pk), pl);
                const uint32_t sprev = __shfl_sync(kFull, pick(sy, pk), pl);
                if (fval > fprev) {
                    if (lane == owner) {
                        place(fr, klb, fprev);
                        place(sy, klb, sprev);
                    }
                    if (lane == pl) {
                        place(fr, pk, fval);
                        place(sy, pk, s);
                    }
                }
            }
        }
        if (t0 + lane < T) {
            out_cf[base + t0 + lane] = my_cf;
            out_tot[base + t0 + lane] = my_tot;
        }
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
    if (cap == 128) {
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
