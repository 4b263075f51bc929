// Shared definitions of the port's kernels (register convention of
// kmers_tpu_torch/convert.py), the byte classification of the front-ends,
// the packed byte tile of K1, K3, K4 and K5 and the packed code tile of K6
// and K8b.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// register word of an invalid window: INT64_MAX sorts after every real word
#define KMERS_SENTINEL 0x7FFFFFFFFFFFFFFFLL

namespace kmers {

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

// The packed tile of the canonical front-ends (K1, K3).  A block of
// kPackThreads threads owns kTile consecutive positions from `base`.  It
// classifies the bytes [base, base + 32 * kWords) once, reads past the chunk's
// end as flagged, and packs them 32 to a word:
// - code[2w] and code[2w + 1] are the low and high halves of the 64-bit code
//   word of bytes 32w .. 32w + 31: byte 32w + l's 2-bit code at bits 2l and
//   2l + 1, so the first base sits in the low bits;
// - flag[w] has bit l set where byte 32w + l is not a certain base or lies at
//   or past the chunk's end.
// Then a window of K <= 31 bases is two funnel shifts of three code halves
// (code_slice64), K <= 63 four of five (code_slice128), and its flags one or
// two funnel shifts of flag words, whatever K is.
constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kTile = 1024;       // positions a block owns

// A byte's class in one word: its packed code (the 2-bit code, or kFlag),
// plus 1 << 8 where it is ambiguous and 1 << 20 where it is invalid, so that
// a thread tallies both classes of its bytes with one add a byte.
constexpr uint32_t kAmbigOne = 1u << 8;
constexpr uint32_t kInvalidOne = 1u << 20;

__device__ __forceinline__ uint32_t byte_class(uint32_t b) {
    bool ambig, invalid;
    const uint32_t c = classify(b, ambig, invalid);
    return c | (ambig ? kAmbigOne : 0u) | (invalid ? kInvalidOne : 0u);
}

template <int kWords>
struct alignas(16) PackedTile {
    static_assert(kWords * 32 >= kTile + 32, "a tile needs its owned words and a halo word");
    uint32_t lut[256];                // byte_class of every byte value
    uint32_t code[2 * kWords];
    uint32_t flag[kWords];
    uint32_t totals[kPackWarps];      // each warp's byte classes, summed
};

// One word of the tile, warp-wide: lane l classifies byte 32w + l of the
// block (`lim` bytes of it lie inside the chunk) and returns its class.
template <int kWords>
__device__ __forceinline__ uint32_t pack_word(const uint8_t* __restrict__ bytes,
                                              int lim, int w,
                                              PackedTile<kWords>& tile) {
    const int lane = threadIdx.x & 31;
    const int j = 32 * w + lane;
    const uint32_t e = j < lim ? tile.lut[bytes[j]] : kFlag;
    // a flagged byte's code is 0; its windows are sentinels whatever it is
    const uint64_t v = static_cast<uint64_t>(e & 3u) << (2 * lane);
    const uint32_t lo = __reduce_or_sync(~0u, static_cast<uint32_t>(v));
    const uint32_t hi = __reduce_or_sync(~0u, static_cast<uint32_t>(v >> 32));
    const uint32_t f = __ballot_sync(~0u, e & kFlag);
    if (lane == 0) {
        reinterpret_cast<uint2*>(tile.code)[w] = make_uint2(lo, hi);
        tile.flag[w] = f;
    }
    return e;
}

// Fill `tile` for the block at `base`.  With kCount, add the invalid and
// ambiguous bytes among its kTile own bytes (each byte counted once, by the
// block that owns it, never as another block's halo) into counters[0] and
// counters[1], one atomic pair a block; without it (the six-frame
// front-ends) `counters` is not read.  Ends in a block-wide barrier, so the
// tile is complete on return.  Every thread of the block must call it.
template <int kWords, bool kCount = true>
__device__ __forceinline__ void pack_tile(const uint8_t* __restrict__ bytes,
                                          int64_t n, int64_t base,
                                          PackedTile<kWords>& tile,
                                          unsigned long long* counters) {
    static_assert(kPackThreads == 256, "one thread a byte value fills the table");
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    tile.lut[threadIdx.x] = byte_class(threadIdx.x);
    __syncthreads();
    const uint8_t* block = bytes + base;
    const int lim = static_cast<int>(n - base < 32 * kWords ? n - base : 32 * kWords);
    // at most 4 bytes a lane: the code bits (< 2^8) stay out of the counts
    uint32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kTile / kPackThreads; ++k)
        sum += pack_word(block, lim, k * kPackWarps + warp, tile);
    // the halo words; every lane of a warp takes the same branch
    for (int w = kTile / 32 + warp; w < kWords; w += kPackWarps)
        pack_word(block, lim, w, tile);
    if constexpr (!kCount) {
        __syncthreads();
        return;
    }
    // at most kTile bytes a block: each count fits its 12 bits
    sum = __reduce_add_sync(~0u, sum & ~(kAmbigOne - 1));
    if (lane == 0) tile.totals[warp] = sum;
    __syncthreads();
    if (warp == 0) {
        sum = __reduce_add_sync(~0u, lane < kPackWarps ? tile.totals[lane] : 0u);
        const uint32_t n_invalid = sum / kInvalidOne;
        const uint32_t n_ambig = (sum % kInvalidOne) / kAmbigOne;
        if (lane == 0 && n_invalid) atomicAdd(&counters[0], static_cast<unsigned long long>(n_invalid));
        if (lane == 0 && n_ambig) atomicAdd(&counters[1], static_cast<unsigned long long>(n_ambig));
    }
}

// Bits 2s .. 2s + 63 of the code stream from word w: the 2-bit codes of the
// 32 bytes from 32w + s (0 <= s < 32), the first in the low bits.
__device__ __forceinline__ uint64_t code_slice64(const uint32_t* code, int w, int s) {
    const uint32_t* c = code + 2 * w + (s >> 4);
    const int r = (2 * s) & 31;
    const uint32_t a = c[0], b = c[1], d = c[2];
    return (static_cast<uint64_t>(__funnelshift_r(b, d, r)) << 32) | __funnelshift_r(a, b, r);
}

// The same for bits 2s .. 2s + 127 (64 bytes), as (low, high) 64-bit halves.
__device__ __forceinline__ void code_slice128(const uint32_t* code, int w, int s,
                                              uint64_t& lo, uint64_t& hi) {
    const uint32_t* c = code + 2 * w + (s >> 4);
    const int r = (2 * s) & 31;
    const uint32_t a = c[0], b = c[1], d = c[2], e = c[3], f = c[4];
    lo = (static_cast<uint64_t>(__funnelshift_r(b, d, r)) << 32) | __funnelshift_r(a, b, r);
    hi = (static_cast<uint64_t>(__funnelshift_r(e, f, r)) << 32) | __funnelshift_r(d, e, r);
}

// The packed tile of a code stream (K6, K8b): the codes (each below 2^kBps)
// and good flags of the kCodeGroups * 32 symbols from `base`, kBps bits a
// symbol, the first in the low bits:
// - code holds symbol j at bits kBps * j .. kBps * j + kBps - 1 of the
//   little-endian bit stream of its words (kBps words a group of 32);
// - flag[g] has bit l set where symbol 32g + l is not good or lies at or
//   past the stream's end (whose code is then 0).
// A bad symbol keeps its code: K8b writes the registers of invalid windows.
// kTile owned symbols and one halo group cover K - 1 <= 31.
constexpr int kCodeGroups = kTile / 32 + 1;

template <int kBps>
struct alignas(16) CodeTile {
    static_assert(kBps == 2 || kBps == 4 || kBps == 8, "2, 4 or 8 bits a symbol");
    uint32_t code[kBps * kCodeGroups];
    uint32_t flag[kCodeGroups];
};

// Fill `tile` for the block at `base`: warp w packs the groups w, w + 8, ...
// Lane l reads code and good byte 32g + l (one byte a lane, coalesced: a
// view may start anywhere), ORs its code into word kBps * l / 32 of the
// group with __reduce_or_sync (at 8 bits the code byte is stored as it is,
// the same layout) and ballots its flag.  Ends in a block-wide barrier.
// Every thread of the block must call it.
template <int kBps>
__device__ __forceinline__ void pack_codes(const uint8_t* __restrict__ codes,
                                           const uint8_t* __restrict__ good,
                                           int64_t n, int64_t base,
                                           CodeTile<kBps>& tile) {
    constexpr int kOwned = kTile / 32 / kPackWarps;   // groups a warp owns
    constexpr int kPerWord = 32 / kBps;               // symbols a code word
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int lim = static_cast<int>(n - base < 32 * kCodeGroups ? n - base : 32 * kCodeGroups);
    const uint8_t* __restrict__ c = codes + base;
    const uint8_t* __restrict__ q = good + base;
    // every load of the thread first, then the packing
    uint32_t code[kOwned + 1];
    bool bad[kOwned + 1];
#pragma unroll
    for (int k = 0; k <= kOwned; ++k) {
        const int g = k * kPackWarps + warp;
        const int j = 32 * g + lane;
        const bool in = g < kCodeGroups && j < lim;
        code[k] = in ? c[j] : 0u;
        bad[k] = !in || !q[j];
    }
#pragma unroll
    for (int k = 0; k <= kOwned; ++k) {
        const int g = k * kPackWarps + warp;
        // the halo group: one warp; every lane of a warp takes the same branch
        if (k == kOwned && g >= kCodeGroups) break;
        const uint32_t f = __ballot_sync(~0u, bad[k]);
        if constexpr (kBps == 8) {
            reinterpret_cast<uint8_t*>(tile.code)[32 * g + lane] = static_cast<uint8_t>(code[k]);
        } else {
            const uint32_t v = code[k] << (kBps * (lane % kPerWord));
            uint32_t w[kBps];
#pragma unroll
            for (int i = 0; i < kBps; ++i)
                w[i] = __reduce_or_sync(~0u, lane / kPerWord == i ? v : 0u);
            if (lane == 0) {
                if constexpr (kBps == 2)
                    reinterpret_cast<uint2*>(tile.code)[g] = make_uint2(w[0], w[1]);
                else
                    reinterpret_cast<uint4*>(tile.code)[g] = make_uint4(w[0], w[1], w[2], w[3]);
            }
        }
        if (lane == 0) tile.flag[g] = f;
    }
    __syncthreads();
}

// Bits kBps * p .. kBps * p + 63 of a CodeTile's code words: the codes of
// the 64 / kBps symbols from p, the first in the low bits.
template <int kBps>
__device__ __forceinline__ uint64_t code_slice64_at(const uint32_t* code, int p) {
    const int bit = kBps * p;
    const uint32_t* c = code + (bit >> 5);
    const int r = bit & 31;
    const uint32_t a = c[0], b = c[1], d = c[2];
    return (static_cast<uint64_t>(__funnelshift_r(b, d, r)) << 32) | __funnelshift_r(a, b, r);
}

// The flags of the 32 (flag_slice32) or 64 (flag_slice64) bytes from
// 32w + s, the first in bit 0.
__device__ __forceinline__ uint32_t flag_slice32(const uint32_t* flag, int w, int s) {
    return __funnelshift_r(flag[w], flag[w + 1], s);
}

__device__ __forceinline__ uint64_t flag_slice64(const uint32_t* flag, int w, int s) {
    const uint32_t a = flag[w], b = flag[w + 1], c = flag[w + 2];
    return (static_cast<uint64_t>(__funnelshift_r(b, c, s)) << 32) | __funnelshift_r(a, b, s);
}

// Swap the two bits of every 2-bit symbol: turns a bit reversal of a word
// into a reversal of its symbols.  Written on 32-bit halves: no bit crosses
// them, and the compiler then needs three instructions a half.
__device__ __forceinline__ uint32_t swap_bit_pairs32(uint32_t z) {
    return ((z >> 1) & 0x55555555u) | ((z << 1) & 0xAAAAAAAAu);
}

__device__ __forceinline__ uint64_t swap_bit_pairs(uint64_t z) {
    return (static_cast<uint64_t>(swap_bit_pairs32(static_cast<uint32_t>(z >> 32))) << 32) |
           swap_bit_pairs32(static_cast<uint32_t>(z));
}

}  // namespace kmers
