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
// planes that two further device passes counted and compacted.  Here one
// thread owns one stream, keeps (low, range, cache, ffnum, carry) in
// registers, divides exactly in u32, and writes the output bytes
// directly: a flushing shift_low emits (cache + carry) & 0xFF and then
// ffnum bytes of (carry - 1) & 0xFF.
//
// What bounds it on the H100: the per-stream dependency chain (divide,
// multiply-add, compare, shift) once per step, for as many steps as the
// stream has symbols; the adaptive codecs' streams are few and long, so
// few threads run and each is latency-bound.  Memory traffic is 8 bytes
// in and at most about 2 bytes out per step.  The design keeps loads off
// the chain: each thread reads its stream's steps contiguously, kPre
// steps at a time ahead of the arithmetic that uses them.
//
// Layout: cf[i] = cum << 16 | freq and tot[i] for every step i of every
// stream; stream b walks cf[off[b] .. off[b] + n[b]).  The state (5, B)
// u32 comes in and goes out, so a long stream walks in chunks.  Stream b
// writes its bytes to out[b * cap ..]; totals[b] counts them even past
// cap, where nothing is written, so the caller can tell an overflow.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr uint32_t kThresh = 0xFFu << 24;
constexpr int kPre = 16;
constexpr int kThreads = 128;

__device__ __forceinline__ void put(uint8_t* o, long long pos, long long cap,
                                    uint32_t v) {
    if (pos < cap) o[pos] = (uint8_t)v;
}

__global__ void rc_walk_kernel(const uint32_t* __restrict__ cf,
                               const uint32_t* __restrict__ tot,
                               const long long* __restrict__ off,
                               const int32_t* __restrict__ n,
                               const uint32_t* __restrict__ st_in, int B,
                               long long cap, uint8_t* __restrict__ out,
                               int32_t* __restrict__ totals,
                               uint32_t* __restrict__ st_out) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    uint32_t low = st_in[b], rng = st_in[B + b], cache = st_in[2 * B + b];
    uint32_t ffnum = st_in[3 * B + b], carry = st_in[4 * B + b];
    const uint32_t* pc = cf + off[b];
    const uint32_t* pt = tot + off[b];
    const int steps = n[b];
    uint8_t* o = out + (long long)b * cap;
    long long pos = 0;

    for (int t0 = 0; t0 < steps; t0 += kPre) {
        uint32_t c[kPre], tt[kPre];
        const int m = min(kPre, steps - t0);
#pragma unroll
        for (int k = 0; k < kPre; ++k) {
            if (k < m) {
                c[k] = pc[t0 + k];
                tt[k] = pt[t0 + k];
            }
        }
#pragma unroll
        for (int k = 0; k < kPre; ++k) {
            if (k >= m) break;
            const uint32_t q = rng / tt[k];
            const uint32_t nl = low + (c[k] >> 16) * q;
            carry += nl < low;
            low = nl;
            rng = q * (c[k] & 0xFFFFu);
#pragma unroll
            for (int s = 0; s < 2; ++s) {
                if (rng >= kTop) break;
                if (low < kThresh || carry) {
                    put(o, pos++, cap, cache + carry);
                    const uint32_t run = carry - 1;
                    for (uint32_t j = 0; j < ffnum; ++j) put(o, pos++, cap, run);
                    cache = low >> 24;
                    ffnum = 0;
                    carry = 0;
                } else {
                    ++ffnum;
                }
                low <<= 8;
                rng <<= 8;
            }
        }
    }
    totals[b] = (int32_t)min(pos, (long long)INT_MAX);
    st_out[b] = low;
    st_out[B + b] = rng;
    st_out[2 * B + b] = cache;
    st_out[3 * B + b] = ffnum;
    st_out[4 * B + b] = carry;
}

}  // namespace

extern "C" int fqz5_rc_encode_walk(const uint32_t* cf, const uint32_t* tot,
                                   const long long* off, const int32_t* n,
                                   const uint32_t* st_in, int B,
                                   long long cap, uint8_t* out,
                                   int32_t* totals, uint32_t* st_out,
                                   void* stream) {
    if (B <= 0) return 0;
    const dim3 grid((B + kThreads - 1) / kThreads);
    rc_walk_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        cf, tot, off, n, st_in, B, cap, out, totals, st_out);
    return (int)cudaGetLastError();
}
