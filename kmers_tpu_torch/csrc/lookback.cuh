// The single-pass decoupled look-back of the kernels that front-pack what
// their tiles keep (K9's merge-reduce, K12): each tile publishes how many
// rows it keeps, then finds its output offset from the tiles before it.
// Tiles take their index by an atomic ticket, in launch order, so a tile
// only ever waits on tiles that are running.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kmers {

// A tile's status word: 0 until the tile publishes; then kAggregate | its
// kept rows; then kPrefix | the kept rows of it and every tile before it.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kValue = kAggregate - 1;

__device__ __forceinline__ void publish(unsigned long long* p, unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
    return v;
}

// By a whole warp of tile g > 0: the kept rows of tiles 0 .. g - 1.  It reads
// the status words of the 32 tiles before a point, nearest first, waits
// until those up to the nearest inclusive prefix have published, and sums
// back to it.
__device__ __forceinline__ unsigned long long look_back(const unsigned long long* status,
                                                        int64_t g) {
    const int lane = threadIdx.x & 31;
    unsigned long long before = 0;
    for (int64_t top = g - 1;; top -= 32) {
        const int64_t t = top - lane;
        // a "tile" before tile 0 holds the prefix 0
        unsigned long long w = t >= 0 ? peek(status + t) : kPrefix;
        unsigned prefix, need;
        for (;;) {
            prefix = __ballot_sync(0xFFFFFFFFu, w >= kPrefix);
            // lanes up to the nearest prefix, or all 32 without one
            need = prefix ? (prefix ^ (prefix - 1)) : 0xFFFFFFFFu;
            if (!(__ballot_sync(0xFFFFFFFFu, w < kAggregate) & need)) break;
            if (w < kAggregate) w = peek(status + t);
        }
        before += warp_sum(need >> lane & 1u ? (w & kValue) : 0);
        if (prefix) return before;
    }
}

}  // namespace kmers
