// K4 and K5: six-frame amino-acid window registers.  ASCII bytes -> for
// every base anchor p, both strands' registers of the K codons at
// p, p + 3, ..., p + 3(K - 1), 8 bits an amino acid: the forward register
// with the earliest codon highest, the reverse register
// sum_k RC_AA[p + 3k] << 8k (RC_AA: the amino acid of the reverse-complement
// codon over the same three bases, so the earliest reverse codon is highest
// and at the largest forward position).  A window is emitted where all its
// 3K bases are certain (A/C/G/T/U, either case), it ends inside the input,
// and p lies inside its strand's bounds [lo, hi); every other column is
// INT64_MAX.  Output in natural order: forward window p at column p,
// reverse window p at column n + p; plus the number of emitted windows.
// K4 (1 <= K <= 7) writes one int64 key a window (8K <= 56 bits); K5
// (8 <= K <= 32) writes W = ceil(8K / 62) word planes of 62 bits, word 0
// the most significant (the convention of kmers_tpu_torch/convert.py).
//
// Replaces the TPU kernels kmers_tpu/ops/pallas/sixframe_kernel.py
// sixframe_windows_u32_pallas (_kernel_sixframe) and
// sixframe_windows_mw_u32_pallas (_kernel_sixframe_mw), with
// _dual_aa_streams, _tree16 and _accum_cnt.
//
// What bounds it on an H100: per base it moves 1 byte in and 16 W bytes out
// (16 for K4, 32 at K = 15), so device memory is the limit; its inner loop
// does K shared-memory reads and ORs per anchor.
//
// Design, and where the TPU design does not carry over:
// - One thread per anchor, as in K1: a block stages its 256 classified bytes
//   plus a 3K - 1 <= 95-byte halo (flagged past the end, so a window that
//   runs past the input is invalid by its flags), then the dual amino acid of
//   the codon at every staged position, once, into shared memory: the 64-entry
//   table tbl[c] | tbl[revcomp(c)] << 8 (sixframe_tbl16) is a kernel argument,
//   copied to shared memory and indexed, where the TPU kernel compiled it into
//   a 63-select tree; bit 16 of a staged codon marks a base that is not
//   certain.  The OR of the K codons' entries gives both strands' validity.
// - The TPU kernel's four byte slots per u32 lane, its pltpu.roll carries
//   across tiles and its offset-major output order stay behind.
// - K5's register is 256 bits (two unsigned __int128), each amino acid ORed
//   into its byte, then cut into 62-bit words.  A real word is below 2^62, so
//   INT64_MAX marks an invalid window in every word and K5 needs no validity
//   stream (the TPU kernel's all-ones sentinel equals a real register where
//   8K fills its 32-bit limbs).
// - The count of emitted windows is two __syncthreads_count block totals,
//   added with one atomicAdd a block (the TPU kernel carried it in lane 0
//   across its sequential grid).
#include "common.cuh"

namespace {

using kmers::kBlock;
using kmers::kFlag;
typedef unsigned __int128 u128;

constexpr int kMaxK = 32;
constexpr int kMaxHalo = 3 * kMaxK - 1;  // bytes past the block its anchors read
constexpr int kWordBits = 62;
constexpr uint32_t kBadCodon = 1u << 16;  // staged codon: a base not certain

struct DualTable {
    uint16_t v[64];
};

struct Bounds {
    long long fw_lo, fw_hi, rv_lo, rv_hi;
};

// K4's register: 8K <= 56 bits
struct Reg64 {
    uint64_t v = 0;
    __device__ __forceinline__ void put(uint32_t aa, int j) {
        v |= static_cast<uint64_t>(aa) << (8 * j);
    }
    __device__ __forceinline__ uint64_t word(int) const { return v; }
};

// K5's register: 8K <= 256 bits as hi:lo
struct Reg256 {
    u128 hi = 0, lo = 0;
    __device__ __forceinline__ void put(uint32_t aa, int j) {
        if (j < 16) {
            lo |= static_cast<u128>(aa) << (8 * j);
        } else {
            hi |= static_cast<u128>(aa) << (8 * j - 128);
        }
    }
    // the 62 bits from bit s (s = 0, 62, 124, 186 or 248)
    __device__ __forceinline__ uint64_t word(int s) const {
        u128 x;
        if (s >= 128) {
            x = hi >> (s - 128);
        } else if (s == 0) {
            x = lo;
        } else {
            x = (lo >> s) | (hi << (128 - s));
        }
        return static_cast<uint64_t>(x) & ((1ull << kWordBits) - 1);
    }
};

__device__ __forceinline__ uint8_t stage(const uint8_t* __restrict__ bytes,
                                         int64_t j, int64_t n) {
    bool ambig, invalid;
    return j < n ? kmers::classify(bytes[j], ambig, invalid) : kFlag;
}

template <typename Reg>
__global__ void __launch_bounds__(kBlock)
sixframe_kernel(const uint8_t* __restrict__ bytes, int64_t n, int K, int W,
                Bounds bounds, DualTable table, int64_t* __restrict__ out,
                unsigned long long* __restrict__ n_valid) {
    __shared__ uint8_t tile[kBlock + kMaxHalo];
    __shared__ uint32_t codon[kBlock + kMaxHalo - 2];
    __shared__ uint16_t tbl[64];
    const int t = threadIdx.x;
    const int halo = 3 * K - 1;
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kBlock;
    const int64_t i = base + t;
    if (t < 64) tbl[t] = table.v[t];
    tile[t] = stage(bytes, i, n);
    if (t < halo) tile[kBlock + t] = stage(bytes, base + kBlock + t, n);
    __syncthreads();
    // the codon at every position an anchor of this block reads
    for (int q = t; q < kBlock + halo - 2; q += kBlock) {
        const uint32_t a = tile[q], b = tile[q + 1], c = tile[q + 2];
        const uint32_t cod = ((a & 3u) << 4) | ((b & 3u) << 2) | (c & 3u);
        codon[q] = tbl[cod] | (((a | b | c) & kFlag) ? kBadCodon : 0u);
    }
    __syncthreads();

    bool emit_f = false, emit_r = false;
    Reg fw, rv;
    if (i < n) {
        uint32_t bad = 0;
        for (int k = 0; k < K; ++k) {
            const uint32_t e = codon[t + 3 * k];
            bad |= e;
            fw.put(e & 0xFFu, K - 1 - k);
            rv.put((e >> 8) & 0xFFu, k);
        }
        const bool ok = !(bad & kBadCodon);
        emit_f = ok && i >= bounds.fw_lo && i < bounds.fw_hi;
        emit_r = ok && i >= bounds.rv_lo && i < bounds.rv_hi;
        for (int w = 0; w < W; ++w) {
            const int s = kWordBits * (W - 1 - w);
            int64_t* plane = out + static_cast<int64_t>(w) * 2 * n;
            plane[i] = emit_f ? static_cast<int64_t>(fw.word(s)) : KMERS_SENTINEL;
            plane[n + i] = emit_r ? static_cast<int64_t>(rv.word(s)) : KMERS_SENTINEL;
        }
    }
    const int emitted = __syncthreads_count(emit_f) + __syncthreads_count(emit_r);
    if (t == 0 && emitted) atomicAdd(n_valid, static_cast<unsigned long long>(emitted));
}

template <typename Reg>
int launch(const void* bytes, long long n, int K, int W, long long fw_lo,
           long long fw_hi, long long rv_lo, long long rv_hi, const void* tbl16,
           void* out, void* n_valid, void* stream) {
    if (n > 0) {
        DualTable table;
        const auto* src = static_cast<const uint16_t*>(tbl16);
        for (int c = 0; c < 64; ++c) table.v[c] = src[c];
        const long long blocks = (n + kBlock - 1) / kBlock;
        sixframe_kernel<Reg><<<static_cast<unsigned>(blocks), kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(bytes), n, K, W,
            Bounds{fw_lo, fw_hi, rv_lo, rv_hi}, table,
            static_cast<int64_t*>(out),
            static_cast<unsigned long long*>(n_valid));
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4.  bytes: uint8[n]; tbl16: HOST uint16[64] (sixframe_tbl16); keys:
// int64[2n]; n_valid: int64[1] zeroed by the caller.  1 <= K <= 7.
extern "C" int k4_sixframe_windows(const void* bytes, long long n, int K,
                                   long long fw_lo, long long fw_hi,
                                   long long rv_lo, long long rv_hi,
                                   const void* tbl16, void* keys,
                                   void* n_valid, void* stream) {
    if (K < 1 || K > 7) return static_cast<int>(cudaErrorInvalidValue);
    return launch<Reg64>(bytes, n, K, 1, fw_lo, fw_hi, rv_lo, rv_hi, tbl16,
                         keys, n_valid, stream);
}

// K5.  As K4, with words: int64[W * 2n] (W word planes of 2n), W =
// ceil(8K / 62).  8 <= K <= 32.
extern "C" int k5_sixframe_words(const void* bytes, long long n, int K,
                                 long long fw_lo, long long fw_hi,
                                 long long rv_lo, long long rv_hi,
                                 const void* tbl16, void* words,
                                 void* n_valid, void* stream) {
    if (K < 8 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
    const int W = (8 * K + kWordBits - 1) / kWordBits;
    return launch<Reg256>(bytes, n, K, W, fw_lo, fw_hi, rv_lo, rv_hi, tbl16,
                          words, n_valid, stream);
}
