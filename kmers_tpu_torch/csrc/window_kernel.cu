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
// (one byte in, one 8-byte register or key out), and its inner loop issues
// O(K) shared-memory reads and shifts (over a hundred integer instructions
// a position at K = 31; the hash adds one 64-bit multiply), so at large K
// the instruction issue rate, not memory, is the nearer limit.
//
// Design, and where the TPU design does not carry over:
// - One thread per position.  A block stages its 256 positions plus a K-1
//   byte halo in shared memory, classified once, and bounds the halo at the
//   chunk's end itself (the TPU kernel read the next tile through a clamped
//   BlockSpec and swapped in 'N' groups on the last tile).
// - Bytes are read one at a time: chunks start at multiples of
//   2^20 - (K - 1), which are not 4-byte aligned, so a view into one device
//   buffer must not be read through uint32 or vector loads.
// - The reverse complement is computed in-register, as _canonical does:
//   complement under the coding mask, 64-bit bit reversal, swap of adjacent
//   bit pairs, shift right by 64 - 2K.
// - Counters: TPU grid steps run in order and accumulated in one block;
//   CUDA blocks run in no order, so each block reduces its own bytes with
//   __syncthreads_count and adds them atomically into a zeroed int64[2].
// - Output is in natural position order (the TPU tile relabelling is not
//   copied).
// Rolling the register over several positions per thread, to make the work
// O(1) per position, is left to a later change.
#include "common.cuh"

namespace {

using kmers::kBlock;
using kmers::kFlag;

constexpr int kMaxHalo = 30;      // K - 1 for K <= 31
constexpr uint64_t kFx = 0x517cc1b727220a95ull;   // FxHash's multiplier

template <bool kHash>
__global__ void __launch_bounds__(kBlock)
canonical_windows_kernel(const uint8_t* __restrict__ bytes, int64_t n, int K,
                         int64_t* __restrict__ keys,
                         unsigned long long* __restrict__ counters) {
    __shared__ uint8_t tile[kBlock + kMaxHalo];
    kmers::stage_tile(bytes, n, K - 1, tile, counters);
    const int t = threadIdx.x;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + t;
    if (i >= n) return;

    int64_t out = KMERS_SENTINEL;
    if (i + K <= n) {
        uint64_t fw = 0;
        uint32_t flags = 0;
        for (int j = 0; j < K; ++j) {
            const uint8_t p = tile[t + j];
            fw = (fw << 2) | (p & 3u);
            flags |= p;
        }
        if (!(flags & kFlag)) {
            const uint64_t mask = (1ull << (2 * K)) - 1;
            const uint64_t rc =
                kmers::swap_bit_pairs(__brevll(~fw & mask)) >> (64 - 2 * K);
            const uint64_t can = fw < rc ? fw : rc;
            out = static_cast<int64_t>(kHash ? (can * kFx) ^ (1ull << 63) : can);
        }
    }
    keys[i] = out;
}

}  // namespace

// keys: int64[n]; counters: int64[2] zeroed by the caller (invalid,
// ambiguous); emit_hash != 0 selects hash mode.
extern "C" int k1_canonical_windows(const void* bytes, long long n, int K,
                                    int emit_hash, void* keys, void* counters,
                                    void* stream) {
    if (K < 1 || K > 31) return static_cast<int>(cudaErrorInvalidValue);
    if (n > 0) {
        const long long blocks = (n + kBlock - 1) / kBlock;
        auto kernel = emit_hash ? canonical_windows_kernel<true>
                                : canonical_windows_kernel<false>;
        kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(bytes), n, K,
            static_cast<int64_t*>(keys),
            static_cast<unsigned long long*>(counters));
    }
    return static_cast<int>(cudaGetLastError());
}
