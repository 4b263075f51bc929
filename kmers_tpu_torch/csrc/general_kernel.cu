// K6: window registers over a general code stream.  Per-symbol codes of
// bps = 2, 4 or 8 bits (uint8, each below 2^bps) and a per-symbol good flag
// -> the K-window register of every position, forward or (at 2 and 4 bits)
// canonical, first symbol in the highest bits; INT64_MAX at windows that
// touch a symbol whose flag is 0 and at the last K-1 positions.
// 1 <= K * bps <= 62, so a register stays below 2^62 and never meets the
// sentinel.  K8b is the same kernel at K = 32 and 2 bits (below).
//
// Replaces the TPU kernels kmers_tpu/ops/pallas/general_kernel.py
// windows_pallas_general (_kernel_general with _window_value, _canonical
// and _rc4) and, at K = 32, kmers_tpu/ops/pallas/window_kernel.py
// canonical_windows_pallas.
//
// What bounds it on an H100: per position it moves 2 bytes in (a code byte
// and a flag byte) and 8 (K6) or 9 (K8b: the register and a validity byte)
// out, so device memory is the limit.  Its first design staged 256 codes a
// block as 16-bit entries and rebuilt each window symbol by symbol, a loop
// of K shared-memory reads, 64-bit shifts and ORs a position, so it was
// bound by instruction issue: 483 us on 48.1 M positions at K = 31, 409 at
// K = 15 (30 % of the bound), 458 for K8b.  This design does a fixed amount
// of work a position at any K and any width:
// - Pack (common.cuh, pack_codes): a block of 256 threads owns kTile = 1024
//   positions.  Each warp reads 32 code and flag bytes at a time (one byte a
//   lane, coalesced), ORs the codes into the group's kBps words with
//   __reduce_or_sync (at 8 bits it stores the bytes, the same layout) and
//   ballots the flags into one flag word.  The 33 groups (the block's 1024
//   symbols and a 32-symbol halo, flagged past the stream's end) sit in
//   shared memory.
// - Extract: thread t takes positions t + 256 r, r < 4.  A window is two
//   funnel shifts of three code words from bit kBps * p (code_slice64_at),
//   its validity one funnel shift of two flag words masked to K bits.  With
//   the first symbol in the low bits the slice x holds the window in
//   reversed symbol order, so at 2 bits the reverse complement is ~x & mask
//   and the forward register swap_bit_pairs(brev(x)) >> (64 - 2K); at 4 bits
//   a code's complement is its nibble bit reversal, so the reverse
//   complement is x with each nibble's bits reversed in place, masked, and
//   the forward register the bit reversal of that shifted right by
//   64 - 4K; at 8 bits the forward register is x's byte reversal shifted
//   right by 64 - 8K.  The canonical minimum is unsigned, ties to forward.
// - Store: a warp writes 32 consecutive positions a round, 256 bytes
//   (K8b: and 32 validity bytes), coalesced.
//
// Where the TPU design does not carry over:
// - The TPU kernel packed the codes into uint32 words and built P = 32 / bps
//   offset-major rows from adjacent words, and carried validity as a second
//   packed stream in which a bad symbol was the all-ones code.  Here a block
//   packs its codes once and a window is a slice at any offset; validity is
//   one ballot bit a symbol, so a code byte keeps all 8 bits (bps = 8) and a
//   bad symbol keeps its code (K8b writes the registers of invalid windows).
// - Inputs are read one byte at a time: a caller's view may start anywhere.
// - The halo is bounded at the stream's end by the flags: a window that runs
//   past it is flagged.
// - Output is in natural position order (not the TPU's offset-major rows).
//
// K8b at K = 32 (windows_k32_kernel, forward or canonical at 2 bits): at
// K = 32 the register fills 64 bits and no value is left for a sentinel
// (INT64_MAX is the real 32-mer CTTT...T).  So this instance writes every
// window's full register, unmasked, and a separate bool validity plane; the
// last 31 positions get register 0 and validity 0.  Its mask and flag mask
// are all ones (1 << 64 and 1u << 32 are undefined) and its shift 0, and
// the canonical minimum is unsigned: a 32-mer that starts with G or T has
// its top bit set.
#include "common.cuh"

namespace {

using kmers::kPackThreads;
using kmers::kPackWarps;
using kmers::kTile;

// Reverse the bits of every 4-bit symbol in place: the complement of each
// 4-bit nucleotide code.  On 32-bit halves, as swap_bit_pairs.
__device__ __forceinline__ uint32_t reverse_nibble_bits32(uint32_t z) {
    z = ((z >> 1) & 0x55555555u) | ((z << 1) & 0xAAAAAAAAu);
    return ((z >> 2) & 0x33333333u) | ((z << 2) & 0xCCCCCCCCu);
}

__device__ __forceinline__ uint64_t reverse_nibble_bits(uint64_t z) {
    return (static_cast<uint64_t>(reverse_nibble_bits32(static_cast<uint32_t>(z >> 32))) << 32) |
           reverse_nibble_bits32(static_cast<uint32_t>(z));
}

// The eight bytes of z in reverse order.
__device__ __forceinline__ uint64_t reverse_bytes(uint64_t z) {
    return (static_cast<uint64_t>(__byte_perm(static_cast<uint32_t>(z), 0, 0x0123)) << 32) |
           __byte_perm(static_cast<uint32_t>(z >> 32), 0, 0x0123);
}

// The register of the window whose symbols x holds from its low bits:
// forward, or the unsigned minimum of forward and reverse complement.
template <int kBps, bool kCanonical>
__device__ __forceinline__ uint64_t window_register(uint64_t x, uint64_t mask, int shift) {
    if constexpr (kBps == 2) {
        // the bits of x past the window reverse into the bits the shift drops
        const uint64_t fw = kmers::swap_bit_pairs(__brevll(x)) >> shift;
        if constexpr (!kCanonical) return fw;
        const uint64_t rc = ~x & mask;
        return fw <= rc ? fw : rc;
    } else if constexpr (kBps == 4) {
        const uint64_t y = reverse_nibble_bits(x);
        const uint64_t fw = __brevll(y) >> shift;
        if constexpr (!kCanonical) return fw;
        const uint64_t rc = y & mask;
        return fw <= rc ? fw : rc;
    } else {
        static_assert(!kCanonical, "canonical selection requires a nucleotide width");
        return reverse_bytes(x) >> shift;
    }
}

// One block's kTile positions: pack, then 4 rounds of 32 positions a warp.
// kK32 (K8b): K = 32, the unmasked register and a validity plane.
template <int kBps, bool kCanonical, bool kK32>
__device__ __forceinline__ void windows_tile(const uint8_t* __restrict__ codes,
                                             const uint8_t* __restrict__ good, int64_t n,
                                             int K, int64_t* __restrict__ regs,
                                             bool* __restrict__ valid,
                                             kmers::CodeTile<kBps>& tile) {
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
    kmers::pack_codes<kBps>(codes, good, n, base, tile);

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t rem = n - base;
    const int lim = static_cast<int>(rem < kTile ? rem : kTile);
    uint64_t mask = ~0ull;   // K = 32: all ones, shift 0
    uint32_t kmask = ~0u;
    int shift = 0;
    if constexpr (!kK32) {
        mask = (1ull << (kBps * K)) - 1;
        kmask = (1u << K) - 1;
        shift = 64 - kBps * K;
    }
    int64_t* __restrict__ out = regs + base;
#pragma unroll
    for (int r = 0; r < kTile / kPackThreads; ++r) {
        const int w = r * kPackWarps + warp;
        const int p = 32 * w + lane;
        if (p < lim) {
            const uint64_t x = kmers::code_slice64_at<kBps>(tile.code, p);
            const uint64_t v = window_register<kBps, kCanonical>(x, mask, shift);
            const bool ok = !(kmers::flag_slice32(tile.flag, w, lane) & kmask);
            if constexpr (kK32) {
                // a window past the end: register 0 (its symbols are real
                // up to n, but the contract writes 0 there)
                out[p] = p + 32 <= rem ? static_cast<int64_t>(v) : 0;
                valid[base + p] = ok;
            } else {
                out[p] = ok ? static_cast<int64_t>(v) : KMERS_SENTINEL;
            }
        }
    }
}

template <int kBps, bool kCanonical>
__global__ void __launch_bounds__(kPackThreads)
general_windows_kernel(const uint8_t* __restrict__ codes, const uint8_t* __restrict__ good,
                       int64_t n, int K, int64_t* __restrict__ out) {
    __shared__ kmers::CodeTile<kBps> tile;
    windows_tile<kBps, kCanonical, false>(codes, good, n, K, out, nullptr, tile);
}

template <bool kCanonical>
__global__ void __launch_bounds__(kPackThreads)
windows_k32_kernel(const uint8_t* __restrict__ codes, const uint8_t* __restrict__ good,
                   int64_t n, int64_t* __restrict__ out, bool* __restrict__ valid) {
    __shared__ kmers::CodeTile<2> tile;
    windows_tile<2, kCanonical, true>(codes, good, n, 32, out, valid, tile);
}

unsigned blocks_of(long long n) {
    return static_cast<unsigned>((n + kTile - 1) / kTile);
}

template <int kBps, bool kCanonical>
void launch(const uint8_t* codes, const uint8_t* good, long long n, int K,
            int64_t* out, cudaStream_t stream) {
    general_windows_kernel<kBps, kCanonical>
        <<<blocks_of(n), kPackThreads, 0, stream>>>(codes, good, n, K, out);
}

}  // namespace

// codes, good: uint8[n] (good: 0 or 1); out: int64[n].  bps in {2, 4, 8},
// canonical only at 2 and 4 bits, 1 <= K * bps <= 62.
extern "C" int k6_general_windows(const void* codes_, const void* good_,
                                  long long n, int K, int bps, int canonical,
                                  void* out_, void* stream_) {
    if (K < 1 || K * bps > 62 || (canonical && bps == 8))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n > 0) {
        const auto* codes = static_cast<const uint8_t*>(codes_);
        const auto* good = static_cast<const uint8_t*>(good_);
        auto* out = static_cast<int64_t*>(out_);
        auto stream = static_cast<cudaStream_t>(stream_);
        switch (bps * 2 + (canonical ? 1 : 0)) {
            case 4: launch<2, false>(codes, good, n, K, out, stream); break;
            case 5: launch<2, true>(codes, good, n, K, out, stream); break;
            case 8: launch<4, false>(codes, good, n, K, out, stream); break;
            case 9: launch<4, true>(codes, good, n, K, out, stream); break;
            case 16: launch<8, false>(codes, good, n, K, out, stream); break;
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    return static_cast<int>(cudaGetLastError());
}

// K = 32 at 2 bits.  codes, good: uint8[n] (good: 0 or 1); out: int64[n],
// the unmasked register of every window (0 at the last 31 positions);
// valid: bool[n], the window's symbols all good.
extern "C" int k8b_windows_k32(const void* codes_, const void* good_, long long n,
                               int canonical, void* out_, void* valid_, void* stream_) {
    if (n > 0) {
        const auto* codes = static_cast<const uint8_t*>(codes_);
        const auto* good = static_cast<const uint8_t*>(good_);
        auto* out = static_cast<int64_t*>(out_);
        auto* valid = static_cast<bool*>(valid_);
        auto stream = static_cast<cudaStream_t>(stream_);
        auto kernel = canonical ? windows_k32_kernel<true> : windows_k32_kernel<false>;
        kernel<<<blocks_of(n), kPackThreads, 0, stream>>>(codes, good, n, out, valid);
    }
    return static_cast<int>(cudaGetLastError());
}
