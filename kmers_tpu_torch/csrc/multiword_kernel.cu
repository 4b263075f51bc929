// K3: the fused canonical front-end for 32 <= K <= 63.  ASCII bytes ->
// 2-bit code + flag -> canonical K-window register per position, written as
// W = ceil(K / 31) int64 word planes (word 0 the most significant, 62 bits
// a word: the convention of kmers_tpu_torch/convert.py); every word is
// INT64_MAX at windows that touch a byte other than A/C/G/T/U (either case)
// and at the last K-1 positions; plus the chunk's invalid- and
// ambiguous-byte counts.
//
// Replaces the TPU kernel kmers_tpu/ops/pallas/multiword_kernel.py
// canonical_windows_mw_pallas (_kernel_mw with _canonical_mw, _shr_limbs).
//
// What bounds it on an H100: per position it moves 1 + 8W bytes of device
// memory (17 at K = 47: 2.66 us at 2^19 positions).  Its first design rebuilt
// each window one base at a time from a shared byte tile, a runtime-K loop of
// 128-bit shifts, and was bound by instruction issue (16.1 us at 2^19, K =
// 47: 16 % of the bound).  This design is K1's (window_kernel.cu;
// common.cuh, pack_tile), so the work a position no longer grows with K:
// - the block's 1024 positions and a 64-byte halo (K - 1 <= 62 bytes) are
//   classified once and packed into 34 code and flag words in shared
//   memory, a warp per 32 bytes;
// - a thread's window is four funnel shifts of five code halves (2K <= 126
//   bits from the window's first base, which sits in the low bits), its
//   flags two funnel shifts of three flag words, ANDed with the K-bit mask
//   built in 64 bits;
// - the register is two 64-bit halves: the reverse complement is ~x under
//   the 2K-bit mask; the forward register is the 128-bit reversal of x (the
//   halves swapped, each through __brevll and swap_bit_pairs) shifted right
//   by 128 - 2K (2..64), done as 64-bit shifts by 127 - 2K after one and by
//   2K - 64, each below 64, so K = 32 and K = 63 need no special case; the
//   minimum compares the high halves, then the low ones (the TPU kernel
//   compared M = ceil(2K/32) uint32 limbs one by one);
// - the W = 2 or 3 word planes (a template argument, so their cuts at bits
//   62 and 124 are fixed shifts) get one 8-byte store a position each,
//   coalesced.
// The byte reads, the counters and the natural output order are K1's.  On
// an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md section 6): 4.38 us at
// 2^19 positions at K = 47 (61 % of the bound) and 5.31 us at K = 63
// (74 % of its 3.91 us); 32 registers, no spills.
#include "common.cuh"

namespace {

using kmers::kPackThreads;
using kmers::kPackWarps;
using kmers::kTile;

constexpr int kWords = kTile / 32 + 2;   // two halo words: K - 1 <= 62 bytes
constexpr int kWordBits = 62;

template <int W>
__global__ void __launch_bounds__(kPackThreads)
canonical_windows_mw_kernel(const uint8_t* __restrict__ bytes, int64_t n,
                            int K, int64_t* __restrict__ words,
                            unsigned long long* __restrict__ counters) {
    __shared__ kmers::PackedTile<kWords> tile;
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
    kmers::pack_tile(bytes, n, base, tile, counters);

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int lim = static_cast<int>(n - base < kTile ? n - base : kTile);
    int64_t* __restrict__ out = words + base;
    const uint64_t kmask = (1ull << K) - 1;
    // the register's 2K bits: all 64 of the low half, 2K - 64 of the high;
    // the forward register is the 128-bit reversal shifted right by
    // 128 - 2K (2..64), done as shifts by s1 + 1 and by s2 (both below 64)
    const int s2 = 2 * K - 64, s1 = 63 - s2;
    const uint64_t mask_hi = (1ull << s2) - 1;
    constexpr uint64_t kWordMask = (1ull << kWordBits) - 1;
#pragma unroll
    for (int r = 0; r < kTile / kPackThreads; ++r) {
        const int w = r * kPackWarps + warp;
        const int p = 32 * w + lane;
        if (p < lim) {
            uint64_t xl, xh;
            kmers::code_slice128(tile.code, w, lane, xl, xh);
            // the bits of x past the window reverse into the bits that the
            // shift drops
            const uint64_t rh = kmers::swap_bit_pairs(__brevll(xl));
            const uint64_t rl = kmers::swap_bit_pairs(__brevll(xh));
            const uint64_t fl = ((rl >> 1) >> s1) | (rh << s2);
            const uint64_t fh = (rh >> 1) >> s1;
            const uint64_t rcl = ~xl, rch = ~xh & mask_hi;
            const bool fw_less = fh < rch || (fh == rch && fl < rcl);
            const uint64_t cl = fw_less ? fl : rcl, ch = fw_less ? fh : rch;
            const bool valid = !(kmers::flag_slice64(tile.flag, w, lane) & kmask);
            // word 0 the most significant: bits 124.. (W = 3), 62..123, 0..61
            if (W == 3) out[p] = valid ? static_cast<int64_t>(ch >> 60) : KMERS_SENTINEL;
            out[(W - 2) * n + p] = valid
                ? static_cast<int64_t>(((cl >> kWordBits) | (ch << 2)) & kWordMask)
                : KMERS_SENTINEL;
            out[(W - 1) * n + p] = valid ? static_cast<int64_t>(cl & kWordMask) : KMERS_SENTINEL;
        }
    }
}

}  // namespace

// words: int64[W * n] (W word planes of n); counters: int64[2] zeroed by the
// caller (invalid, ambiguous).
extern "C" int k3_canonical_windows_mw(const void* bytes, long long n, int K,
                                       void* words, void* counters,
                                       void* stream) {
    if (K < 32 || K > 63) return static_cast<int>(cudaErrorInvalidValue);
    if (n > 0) {
        const int W = (K + kWordBits / 2 - 1) / (kWordBits / 2);
        const long long blocks = (n + kTile - 1) / kTile;
        auto kernel = W == 3 ? canonical_windows_mw_kernel<3> : canonical_windows_mw_kernel<2>;
        kernel<<<static_cast<unsigned>(blocks), kPackThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(bytes), n, K,
            static_cast<int64_t*>(words),
            static_cast<unsigned long long*>(counters));
    }
    return static_cast<int>(cudaGetLastError());
}
