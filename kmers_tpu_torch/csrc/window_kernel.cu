// K1: the fused canonical front-end.  ASCII bytes -> 2-bit code + flag ->
// canonical K-window register (K <= 31) per position, INT64_MAX at windows
// that touch a byte other than A/C/G/T/U (either case) and at the last K-1
// positions; plus the chunk's invalid- and ambiguous-byte counts.  In hash
// mode (emit_hash != 0) a valid window holds instead the order key of the
// seed-0 FxHash of its canonical register: reg * FX mod 2^64 with bit 63
// flipped (kmers_tpu_torch/convert.py), so INT64_MAX stays "invalid" (the
// key of the all-ones hash, whose FxHash preimage is >= 2^62: no K <= 31
// register reaches it).
//
// Replaces the TPU kernel kmers_tpu/ops/pallas/window_kernel.py
// canonical_windows_u32_pallas (_kernel_u32 with _group8_of_u32,
// _classify_byte, _is_ambiguous_byte, _canonical, and _fx_mul for
// emit_hash).  The TPU kernel multiplied in 16-bit uint32 partial products
// (_fx_mul); here the multiply is one unsigned 64-bit `*`.
//
// What bounds it on an H100: per position it moves 9 bytes of device memory
// (one byte in, one 8-byte register or key out).  Its first design rebuilt
// each window from a shared byte tile one base at a time, a runtime-K loop of
// a shared-memory read, a 64-bit shift and two ORs per base, so it was bound
// by instruction issue: 14.0 us at 2^20 positions, 20 % of the 2.82 us
// bound.  This design does a fixed amount of work a position at any K:
// - Stage and pack (common.cuh, pack_tile): a block owns kTile = 1024
//   positions.  Each warp classifies 32 bytes at a time (one byte a lane,
//   coalesced, through a 256-entry class table the block fills first), ORs
//   their 2-bit codes into the two 32-bit halves of a code word with
//   __reduce_or_sync and their flags into a flag word with __ballot_sync.
//   The 33 words (the block's 1024 bytes and a 32-byte halo, flagged past the
//   chunk's end) sit in shared memory.
// - Extract: thread t takes positions t, t + 256, t + 512, t + 768.  A
//   window is two funnel shifts of three code halves, its flags one of two
//   flag words, its validity one AND with the K-bit mask.  With the first
//   base in the low bits the slice x holds the window in reversed symbol
//   order, so the reverse complement is ~x & mask and the forward register
//   swap_bit_pairs(brev(x)) >> (64 - 2K): one bit reversal, as before.
// - Store: one 8-byte store a position, 256 bytes a warp, coalesced; the
//   hash is one unsigned 64-bit multiply.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md section 6): 5.15 us
// at 2^20 positions at K = 15 and at K = 31 (55 % of the bound: one wave of
// 1024 blocks), 240 us at 2^26 (75 %) and 180 us in hash mode at 48.1 M
// (72 %); 31 registers, no spills.
//
// Where the TPU design does not carry over:
// - The TPU kernel packed 4 bytes into an 8-bit code group and built each
//   window from 9 groups by 8 lane rolls and fixed shifts; here a warp packs
//   32 bytes into one 64-bit word, and a thread funnel-shifts its window out
//   of two.
// - Chunks start at multiples of 2^20 - (K - 1), which are not 4-byte
//   aligned, so the bytes of a view into one device buffer are read one at
//   a time, never through uint32 or vector loads.
// - The halo is bounded at the chunk's end by the flags (the TPU kernel read
//   the next tile through a clamped BlockSpec and swapped in 'N' groups on
//   the last tile); a window that runs past the end is flagged.
// - Counters: TPU grid steps ran in order and accumulated in one block; CUDA
//   blocks run in no order, so each block reduces its own bytes and adds them
//   atomically into a zeroed int64[2].
// - Output is in natural position order (the TPU tile relabelling is not
//   copied).
#include "common.cuh"

namespace {

using kmers::kPackThreads;
using kmers::kPackWarps;
using kmers::kTile;

constexpr int kWords = kTile / 32 + 1;   // one halo word: K - 1 <= 30 bytes
constexpr uint64_t kFx = 0x517cc1b727220a95ull;   // FxHash's multiplier

template <bool kHash>
__global__ void __launch_bounds__(kPackThreads)
canonical_windows_kernel(const uint8_t* __restrict__ bytes, int64_t n, int K,
                         int64_t* __restrict__ keys,
                         unsigned long long* __restrict__ counters) {
    __shared__ kmers::PackedTile<kWords> tile;
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
    kmers::pack_tile(bytes, n, base, tile, counters);

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int lim = static_cast<int>(n - base < kTile ? n - base : kTile);
    int64_t* __restrict__ out = keys + base;
    const uint64_t mask = (1ull << (2 * K)) - 1;
    const uint32_t kmask = (1u << K) - 1;
    const int shift = 64 - 2 * K;
#pragma unroll
    for (int r = 0; r < kTile / kPackThreads; ++r) {
        const int w = r * kPackWarps + warp;
        const int p = 32 * w + lane;
        if (p < lim) {
            // the bits of x past the window reverse into the bits that the
            // shift drops
            const uint64_t x = kmers::code_slice64(tile.code, w, lane);
            const uint64_t fw = kmers::swap_bit_pairs(__brevll(x)) >> shift;
            const uint64_t rc = ~x & mask;
            const uint64_t can = fw < rc ? fw : rc;
            const uint64_t key = kHash ? (can * kFx) ^ (1ull << 63) : can;
            const bool valid = !(kmers::flag_slice32(tile.flag, w, lane) & kmask);
            out[p] = valid ? static_cast<int64_t>(key) : KMERS_SENTINEL;
        }
    }
}

}  // namespace

// keys: int64[n]; counters: int64[2] zeroed by the caller (invalid,
// ambiguous); emit_hash != 0 selects hash mode.
extern "C" int k1_canonical_windows(const void* bytes, long long n, int K,
                                    int emit_hash, void* keys, void* counters,
                                    void* stream) {
    if (K < 1 || K > 31) return static_cast<int>(cudaErrorInvalidValue);
    if (n > 0) {
        const long long blocks = (n + kTile - 1) / kTile;
        auto kernel = emit_hash ? canonical_windows_kernel<true>
                                : canonical_windows_kernel<false>;
        kernel<<<static_cast<unsigned>(blocks), kPackThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(bytes), n, K,
            static_cast<int64_t*>(keys),
            static_cast<unsigned long long*>(counters));
    }
    return static_cast<int>(cudaGetLastError());
}
