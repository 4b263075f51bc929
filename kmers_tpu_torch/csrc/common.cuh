// Shared definitions of the port's kernels (register convention of
// kmers_tpu_torch/convert.py) and the byte classification of the front-ends.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// register word of an invalid window: INT64_MAX sorts after every real word
#define KMERS_SENTINEL 0x7FFFFFFFFFFFFFFFLL

namespace kmers {

constexpr int kBlock = 256;       // threads per block of the front-ends
constexpr uint8_t kFlag = 4;      // packed byte: not a certain base

// bit i set: letter 'A' + i belongs to the class
constexpr uint32_t kCertainMask =
    (1u << ('A' - 'A')) | (1u << ('C' - 'A')) | (1u << ('G' - 'A')) |
    (1u << ('T' - 'A')) | (1u << ('U' - 'A'));
constexpr uint32_t kAmbigMask =
    (1u << ('M' - 'A')) | (1u << ('R' - 'A')) | (1u << ('S' - 'A')) |
    (1u << ('V' - 'A')) | (1u << ('W' - 'A')) | (1u << ('Y' - 'A')) |
    (1u << ('H' - 'A')) | (1u << ('K' - 'A')) | (1u << ('D' - 'A')) |
    (1u << ('B' - 'A')) | (1u << ('N' - 'A'));

// One ASCII byte -> packed code (2-bit code, or kFlag when not certain),
// and its counter classes (the classes of ASCII_SKIPPING_LUT).
__device__ __forceinline__ uint8_t classify(uint32_t b, bool& ambig,
                                            bool& invalid) {
    const uint32_t li = (b & 0xDFu) - 'A';  // wraps for non-letters
    const bool letter = li < 26u;
    const bool certain = letter && ((kCertainMask >> li) & 1u);
    ambig = (letter && ((kAmbigMask >> li) & 1u)) || b == '-';
    invalid = !certain && !ambig;
    return certain ? static_cast<uint8_t>(((b >> 1) ^ (b >> 2)) & 3u) : kFlag;
}

// Stage a block's kBlock classified bytes plus the next `halo` bytes
// (flagged past the chunk's end) in `tile`, and add the block's invalid and
// ambiguous byte counts (each byte counted once, by its own thread) into
// counters[0] and counters[1].  Ends in block-wide barriers, so the tile is
// complete on return.
__device__ __forceinline__ void stage_tile(const uint8_t* __restrict__ bytes,
                                           int64_t n, int halo, uint8_t* tile,
                                           unsigned long long* counters) {
    const int t = threadIdx.x;
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kBlock;
    const int64_t i = base + t;
    bool ambig = false, invalid = false;
    tile[t] = i < n ? classify(bytes[i], ambig, invalid) : kFlag;
    if (t < halo) {
        const int64_t h = base + kBlock + t;
        bool a, v;
        tile[kBlock + t] = h < n ? classify(bytes[h], a, v) : kFlag;
    }
    const int n_invalid = __syncthreads_count(invalid);
    const int n_ambig = __syncthreads_count(ambig);
    if (t == 0) {
        if (n_invalid) atomicAdd(&counters[0], static_cast<unsigned long long>(n_invalid));
        if (n_ambig) atomicAdd(&counters[1], static_cast<unsigned long long>(n_ambig));
    }
}

// Swap the two bits of every 2-bit symbol: turns a bit reversal of a word
// into a reversal of its symbols.
__device__ __forceinline__ uint64_t swap_bit_pairs(uint64_t z) {
    return ((z & 0xAAAAAAAAAAAAAAAAull) >> 1) | ((z & 0x5555555555555555ull) << 1);
}

}  // namespace kmers
