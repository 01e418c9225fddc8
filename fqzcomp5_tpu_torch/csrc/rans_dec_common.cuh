// What the 32-lane rANS 32x16 decode walks share (rans_decode.cu,
// rans_decode_bnd.cu): the renormalisation bound, and the word feed of the
// walk that still reads its words from global memory (decode_bnd_o0: one
// warp owns one stream, lane z its state z).  The block walks feed from a
// shared ring instead (rans_dec_walk.cuh).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fqz5 {

constexpr uint32_t kRansL = 1u << 15;

// Renormalise the lanes whose new state Rn fell below 2^15: they take the
// stream's next words in lane order, lane z at ptr + popc(renormalising
// lanes below z), and ptr moves past all of them.  Reads are clipped to
// the row's last word, as rans_jax.decode_scan clips them, so a corrupt
// stream cannot read out of bounds.  Every lane of the warp calls it.
__device__ __forceinline__ uint32_t feed_words(uint32_t Rn,
                                               const uint16_t* __restrict__ w,
                                               long long W, long long& ptr,
                                               uint32_t lt_mask) {
    const bool need = Rn < kRansL;
    const uint32_t bal = __ballot_sync(0xffffffffu, need);
    if (need) {
        long long i = ptr + __popc(bal & lt_mask);
        if (i > W - 1) i = W - 1;
        Rn = (Rn << 16) | w[i];
    }
    ptr += __popc(bal);
    return Rn;
}

}  // namespace fqz5
