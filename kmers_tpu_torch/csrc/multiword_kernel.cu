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
// memory (17 at K = 47), and its inner loop issues O(K) shared-memory reads
// and 128-bit shifts, so, as for K1, the instruction issue rate is the
// nearer limit at large K.
//
// Design: K1's (one thread per position, a shared tile of 256 classified
// bytes plus a K-1 <= 62-byte halo bounded at the chunk's end, byte reads
// only, __syncthreads_count block totals added atomically, natural output
// order), with the register widened to unsigned __int128 (2K <= 126 bits).
// The TPU kernel carried the register as M = ceil(2K/32) uint32 limbs and
// took the lexicographic minimum limb by limb; here the minimum is one
// 128-bit comparison over the whole register.  The in-register reverse
// complement mirrors _canonical_mw: complement under the 2K-bit mask,
// 128-bit bit reversal (the two 64-bit halves swapped, each through
// __brevll), swap of adjacent bit pairs, shift right by 128 - 2K (2..64:
// a 128-bit shift, defined for every K here).
#include "common.cuh"

namespace {

using kmers::kBlock;
using kmers::kFlag;
typedef unsigned __int128 u128;

constexpr int kMaxHalo = 62;      // K - 1 for K <= 63
constexpr int kWordBits = 62;

__global__ void __launch_bounds__(kBlock)
canonical_windows_mw_kernel(const uint8_t* __restrict__ bytes, int64_t n,
                            int K, int W, int64_t* __restrict__ words,
                            unsigned long long* __restrict__ counters) {
    __shared__ uint8_t tile[kBlock + kMaxHalo];
    kmers::stage_tile(bytes, n, K - 1, tile, counters);
    const int t = threadIdx.x;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + t;
    if (i >= n) return;

    bool valid = false;
    u128 can = 0;
    if (i + K <= n) {
        u128 fw = 0;
        uint32_t flags = 0;
        for (int j = 0; j < K; ++j) {
            const uint8_t p = tile[t + j];
            fw = (fw << 2) | (p & 3u);
            flags |= p;
        }
        if (!(flags & kFlag)) {
            const u128 x = ~fw & ((static_cast<u128>(1) << (2 * K)) - 1);
            const uint64_t hi = kmers::swap_bit_pairs(__brevll(static_cast<uint64_t>(x)));
            const uint64_t lo = kmers::swap_bit_pairs(__brevll(static_cast<uint64_t>(x >> 64)));
            const u128 rc = ((static_cast<u128>(hi) << 64) | lo) >> (128 - 2 * K);
            can = fw < rc ? fw : rc;
            valid = true;
        }
    }
    const u128 word_mask = (static_cast<u128>(1) << kWordBits) - 1;
    for (int w = 0; w < W; ++w) {
        const int shift = kWordBits * (W - 1 - w);  // 0, 62 or 124
        words[w * n + i] = valid
            ? static_cast<int64_t>((can >> shift) & word_mask)
            : KMERS_SENTINEL;
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
        const long long blocks = (n + kBlock - 1) / kBlock;
        canonical_windows_mw_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(bytes), n, K, W,
            static_cast<int64_t*>(words),
            static_cast<unsigned long long*>(counters));
    }
    return static_cast<int>(cudaGetLastError());
}
