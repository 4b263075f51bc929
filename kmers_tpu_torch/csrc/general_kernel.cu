// K6: window registers over a general code stream.  Per-symbol codes of
// bps = 2, 4 or 8 bits (uint8, each below 2^bps) and a per-symbol good flag
// -> the K-window register of every position, forward or (at 2 and 4 bits)
// canonical, first symbol in the highest bits; INT64_MAX at windows that
// touch a symbol whose flag is 0 and at the last K-1 positions.
// 1 <= K * bps <= 62, so a register stays below 2^62 and never meets the
// sentinel.
//
// Replaces the TPU kernel kmers_tpu/ops/pallas/general_kernel.py
// windows_pallas_general (_kernel_general with _window_value, _canonical
// and _rc4).
//
// What bounds it on an H100: per position it moves 10 bytes of device
// memory (a code byte and a flag byte in, one 8-byte register out), and its
// inner loop issues O(K) shared-memory reads and shifts, so, as for K1, the
// instruction issue rate is the nearer limit at large K.
//
// Design, and where the TPU design does not carry over:
// - The TPU kernel packed codes and flags into two uint32 word streams and
//   built P = 32 / bps offset-major rows from adjacent words.  Here, as in
//   K1, one thread builds one position: a block stages its 256 codes plus a
//   K-1 halo in shared memory, each as a 16-bit entry (the code in the low
//   byte, bit 8 set where the flag is 0 or the position is past the end),
//   so the halo is bounded at the stream's end by the staging itself.  A
//   code byte can use all 8 bits (bps = 8), so the flag gets its own bit.
// - Inputs are read one byte at a time: a caller's view may start anywhere.
// - Canonical at 2 bits is _canonical's in-register reverse complement
//   (complement under the mask, 64-bit bit reversal, swap of adjacent bit
//   pairs, shift right by 64 - 2K); at 4 bits the complement of a code is
//   its nibble bit reversal, so the reverse complement is one 64-bit bit
//   reversal shifted right by 64 - 4K (_rc4).  The minimum is unsigned,
//   ties to forward.
// - Output is in natural position order (not the TPU's offset-major rows).
// - bps and the canonical flag are template parameters: five kernels, one
//   source.  Rolling the register over several positions per thread is
//   left to a later change.
//
// K8b at K = 32 (windows_k32_kernel, forward or canonical at 2 bits):
// replaces kmers_tpu/ops/pallas/window_kernel.py canonical_windows_pallas at
// K = 32, where the register fills 64 bits and no value is left for a
// sentinel (INT64_MAX is the real 32-mer CTTT...T).  So this instance writes
// every window's full register, unmasked, and a separate bool validity
// plane; the last 31 positions get register 0 and validity 0.  At K = 32 the
// reverse complement's mask is all ones (1 << 64 is undefined) and its shift
// is 0, and the canonical minimum is unsigned: a 32-mer that starts with G
// or T has its top bit set.  Bound: 2 bytes a position in (code and flag),
// 9 out (register and validity).
#include "common.cuh"

namespace {

using kmers::kBlock;

constexpr int kMaxHalo = 30;       // K - 1 for K * bps <= 62
constexpr uint16_t kBad = 0x100;   // staged entry: flag 0 or past the end

__device__ __forceinline__ uint16_t stage(const uint8_t* __restrict__ codes,
                                          const uint8_t* __restrict__ good,
                                          int64_t j, int64_t n) {
    return j < n ? static_cast<uint16_t>(codes[j] | (good[j] ? 0 : kBad)) : kBad;
}

template <int kBps, bool kCanonical>
__global__ void __launch_bounds__(kBlock)
general_windows_kernel(const uint8_t* __restrict__ codes,
                       const uint8_t* __restrict__ good, int64_t n, int K,
                       int64_t* __restrict__ out) {
    __shared__ uint16_t tile[kBlock + kMaxHalo];
    const int t = threadIdx.x;
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kBlock;
    const int64_t i = base + t;
    tile[t] = stage(codes, good, i, n);
    if (t < K - 1) tile[kBlock + t] = stage(codes, good, base + kBlock + t, n);
    __syncthreads();
    if (i >= n) return;

    int64_t res = KMERS_SENTINEL;
    if (i + K <= n) {
        uint64_t fw = 0;
        uint32_t flags = 0;
        for (int j = 0; j < K; ++j) {
            const uint16_t p = tile[t + j];
            fw = (fw << kBps) | (p & 0xFFu);
            flags |= p;
        }
        if (!(flags & kBad)) {
            uint64_t v = fw;
            if constexpr (kCanonical) {
                const int shift = 64 - kBps * K;
                uint64_t rc;
                if constexpr (kBps == 2) {
                    const uint64_t mask = (1ull << (2 * K)) - 1;
                    rc = kmers::swap_bit_pairs(__brevll(~fw & mask)) >> shift;
                } else {
                    rc = __brevll(fw) >> shift;
                }
                v = fw <= rc ? fw : rc;
            }
            res = static_cast<int64_t>(v);
        }
    }
    out[i] = res;
}

constexpr int kHalo32 = 31;  // K - 1 at K = 32

template <bool kCanonical>
__global__ void __launch_bounds__(kBlock)
windows_k32_kernel(const uint8_t* __restrict__ codes, const uint8_t* __restrict__ good,
                   int64_t n, int64_t* __restrict__ out, bool* __restrict__ valid) {
    __shared__ uint16_t tile[kBlock + kHalo32];
    const int t = threadIdx.x;
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kBlock;
    const int64_t i = base + t;
    tile[t] = stage(codes, good, i, n);
    if (t < kHalo32) tile[kBlock + t] = stage(codes, good, base + kBlock + t, n);
    __syncthreads();
    if (i >= n) return;

    uint64_t v = 0;
    bool ok = false;
    if (i + 32 <= n) {
        uint64_t fw = 0;
        uint32_t flags = 0;
        for (int j = 0; j < 32; ++j) {
            const uint16_t p = tile[t + j];
            fw = (fw << 2) | (p & 0xFFu);
            flags |= p;
        }
        v = fw;
        if constexpr (kCanonical) {
            const uint64_t rc = kmers::swap_bit_pairs(__brevll(~fw));
            v = fw <= rc ? fw : rc;
        }
        ok = !(flags & kBad);
    }
    out[i] = static_cast<int64_t>(v);
    valid[i] = ok;
}

template <int kBps, bool kCanonical>
void launch(const uint8_t* codes, const uint8_t* good, long long n, int K,
            int64_t* out, cudaStream_t stream) {
    const long long blocks = (n + kBlock - 1) / kBlock;
    general_windows_kernel<kBps, kCanonical>
        <<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(codes, good, n, K, out);
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
        const unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
        auto stream = static_cast<cudaStream_t>(stream_);
        if (canonical)
            windows_k32_kernel<true><<<blocks, kBlock, 0, stream>>>(codes, good, n, out, valid);
        else
            windows_k32_kernel<false><<<blocks, kBlock, 0, stream>>>(codes, good, n, out, valid);
    }
    return static_cast<int>(cudaGetLastError());
}
