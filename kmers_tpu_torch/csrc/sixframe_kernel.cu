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
// What bounds it on an H100: per anchor it moves 1 byte in and 16 W bytes
// out (16 for K4, 32 at K = 15, 80 at K = 32), so device memory is the
// limit.  Its first design staged 256 anchors a block and rebuilt each
// window codon by codon, a runtime-K loop of shared reads and, for K5,
// variable shifts of 128-bit halves: 16.8 us for K4 and ~77 us for K5 at
// K = 15 at 2^20 bytes (32 % and 13 % of the bound), growing with K.  This
// design does the same work an anchor at any K:
// - Pack (common.cuh, pack_tile, without its byte counters): a block owns
//   kTile = 1024 anchors and packs the 2-bit codes and flags of its bytes and
//   a halo, 32 bytes a word, once.
// - Codons, frame-major: anchor p = 3j + f reads the codons 3(j + k) + f,
//   k < K, which are consecutive in frame f.  So the codon at tile-local
//   position q = 3j + f is computed once (its 6 bits are a slice of the code
//   stream, its "not certain" bit the OR of 3 flag bits, its two amino acids
//   one entry of the 64-entry dual table in shared memory) and stored as
//   byte j of frame f's reverse stream aaR[f] and byte kJ - 1 - j of its
//   reversed forward stream aaFr[f]; a warp takes 32 consecutive j of one
//   frame, so __ballot_sync packs the frame's bad-codon bit words.
// - Windows: thread t takes anchors t + 256 r, r < 4.  The reverse register
//   is the little-endian K-byte slice of aaR[f] from byte j, the forward
//   register the same slice of aaFr[f] from byte kJ - j - K (the byte
//   reversal makes the earliest codon highest), and validity the K-bit slice
//   of frame f's bad words: funnel shifts of shared words by the slice's
//   byte offset, masked to 8K bits.  K5 then cuts the 8K bits into 62-bit
//   words at offsets fixed by W, a template argument; no loop over K and no
//   shift by a runtime amount beyond the funnel shifts and the masks.
// - Store: a warp writes 32 consecutive anchors of each of the 2W planes
//   (256 bytes, coalesced).  The emitted windows are reduced in the block and
//   added with one atomicAdd a block.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md section 6): K4 9.3 us
// at 2^20 bytes at K = 1 and 7 (57 % of the bound: 2^20 bytes are one wave
// of 1024 blocks, whose load, pack and codon phases come before any store),
// K5 12.2 us at K = 15 and 30.0 us at K = 32 (85 %); 31-32 registers, no
// spills.
//
// Where the TPU design does not carry over:
// - The TPU kernel held four byte slots per u32 lane, built each window from
//   K rolled, shifted streams and carried the next tile's streams across the
//   tile boundary with pltpu.roll; here a window is a slice of a frame's
//   stream in shared memory, and the block's halo is packed with its tile.
// - The dual table tbl[c] | tbl[revcomp(c)] << 8 (sixframe_tbl16) is a kernel
//   argument copied to shared memory and indexed (the TPU kernel compiled it
//   into a 63-select tree), permuted so that the code stream's slice, with
//   the first base in its low bits, indexes it directly.
// - A real word is below 2^62, so INT64_MAX marks an invalid window in every
//   word and K5 needs no validity stream (the TPU kernel's all-ones sentinel
//   equals a real register where 8K fills its 32-bit limbs).
// - The count of emitted windows is added atomically, once a block (the TPU
//   kernel carried it in lane 0 across its sequential grid).
#include "common.cuh"

namespace {

using kmers::kPackThreads;
using kmers::kPackWarps;
using kmers::kTile;

constexpr int kMaxK = 32;
// codons a frame stores: j < kJ covers every anchor's K codons (j + k <=
// 341 + 31), and kJ / 32 bad words a frame
constexpr int kJ = 384;
constexpr int kJWords = kJ / 32;
static_assert(kJ > (kTile - 1) / 3 + kMaxK - 1, "a frame holds the last anchor's codons");
// a frame's byte stream, 104 words: room for the L + 1 words a slice reads
// from byte kJ - K (see kLimbs), and the three frames start 8 banks apart, so
// a warp's slices of three frames never share a bank
constexpr int kFrameWords = 104;
constexpr int kPadWords = kFrameWords - kJ / 4;   // past a frame's codons
// codon q = 3j + f < 3 kJ reads the code bits 2q .. 2q + 5 and the flags
// q .. q + 2 through a funnel of two words: kWords packed words cover them
constexpr int kWords = (3 * kJ - 1) / 32 + 2;
static_assert(2 * kWords > (2 * (3 * kJ - 1)) / 32 + 1 && kWords > (3 * kJ - 1) / 32 + 1,
              "every codon's code and flag words are packed");
constexpr int kWordBits = 62;
constexpr uint64_t kWordMask = (1ull << kWordBits) - 1;

struct DualTable {
    uint16_t v[64];
};

struct Bounds {
    long long fw_lo, fw_hi, rv_lo, rv_hi;
};

// the 32-bit limbs of a register of W words: 8K <= min(62 W, 256) bits
template <int W>
constexpr int kLimbs = W == 5 ? 8 : 2 * W;
// the last word of a forward slice: K4 from byte kJ - 1, K5 from kJ - 8
static_assert((kJ - 1) / 4 + kLimbs<1> < kFrameWords && (kJ - 8) / 4 + kLimbs<5> < kFrameWords,
              "a slice's last word lies inside its frame");

struct SixframeTile {
    kmers::PackedTile<kWords> packed;
    uint32_t aaR[3][kFrameWords];    // frame f, byte j: RC_AA of codon 3j + f
    uint32_t aaFr[3][kFrameWords];   // frame f, byte kJ - 1 - j: its AA
    uint32_t bad[3][kJWords];        // frame f, bit j: codon 3j + f not certain
    uint16_t tbl[64];                // the dual table, by code-stream slice
};

// The little-endian L limbs of the bytes of `stream` from byte o, each
// masked (mask[i]: the bits of limb i below 8K).
template <int L>
__device__ __forceinline__ void slice(const uint32_t* stream, int o,
                                      const uint32_t (&mask)[L], uint32_t (&r)[L]) {
    const uint32_t* x = stream + (o >> 2);
    const int s = 8 * (o & 3);
    uint32_t a = x[0];
#pragma unroll
    for (int i = 0; i < L; ++i) {
        const uint32_t b = x[i + 1];
        r[i] = __funnelshift_r(a, b, s) & mask[i];
        a = b;
    }
}

// Word q (0 the least significant) of a register held in L limbs: its bits
// 62q .. 62q + 61; q is a constant once the caller's loop is unrolled.
template <int L>
__device__ __forceinline__ uint64_t word62(const uint32_t (&r)[L], int q) {
    const int b = kWordBits * q, i = b >> 5, s = b & 31;
    const uint32_t x0 = r[i];
    const uint32_t x1 = i + 1 < L ? r[i + 1] : 0u;
    const uint32_t x2 = i + 2 < L ? r[i + 2] : 0u;
    return ((static_cast<uint64_t>(__funnelshift_r(x1, x2, s)) << 32) |
            __funnelshift_r(x0, x1, s)) & kWordMask;
}

template <int W>
__global__ void __launch_bounds__(kPackThreads)
sixframe_kernel(const uint8_t* __restrict__ bytes, int64_t n, int K,
                Bounds bounds, const __grid_constant__ DualTable table,
                int64_t* __restrict__ out,
                unsigned long long* __restrict__ n_valid) {
    constexpr int L = kLimbs<W>;
    __shared__ SixframeTile tile;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
    // the table indexed by the code stream's 6 bits (first base lowest);
    // the frames' padding words, read by slices but masked, are zeroed
    if (t < 64) tile.tbl[t] = table.v[((t & 3) << 4) | (t & 12) | (t >> 4)];
    if (t < 3 * kPadWords) {
        const int f = t / kPadWords, w = kJ / 4 + t % kPadWords;
        tile.aaR[f][w] = 0u;
        tile.aaFr[f][w] = 0u;
    }
    kmers::pack_tile<kWords, false>(bytes, n, base, tile.packed, nullptr);

    // codons, frame-major: unit u is frame u / kJWords, codons j of word
    // u % kJWords; every lane of a warp takes the same branch
    const uint32_t* code = tile.packed.code;
    const uint32_t* flag = tile.packed.flag;
    for (int u = warp; u < 3 * kJWords; u += kPackWarps) {
        const int f = u / kJWords, w = u % kJWords;
        const int j = 32 * w + lane, q = 3 * j + f;
        const int c = 2 * q;
        const uint32_t v = __funnelshift_r(code[c >> 5], code[(c >> 5) + 1], c & 31) & 63u;
        const uint32_t flags = __funnelshift_r(flag[q >> 5], flag[(q >> 5) + 1], q & 31) & 7u;
        const uint32_t e = tile.tbl[v];
        reinterpret_cast<uint8_t*>(tile.aaR[f])[j] = static_cast<uint8_t>(e >> 8);
        reinterpret_cast<uint8_t*>(tile.aaFr[f])[kJ - 1 - j] = static_cast<uint8_t>(e);
        const uint32_t bad = __ballot_sync(~0u, flags != 0u);
        if (lane == 0) tile.bad[f][w] = bad;
    }
    __syncthreads();

    uint32_t mask[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
        const int bits = 8 * K - 32 * i;
        mask[i] = bits >= 32 ? ~0u : bits <= 0 ? 0u : (1u << bits) - 1u;
    }
    const uint32_t kmask = K == 32 ? ~0u : (1u << K) - 1u;
    // the strands' bounds in tile-local anchors, clamped to [0, kTile]
    auto local = [base](long long b) {
        const long long d = b - base;
        return static_cast<int>(d < 0 ? 0 : d > kTile ? kTile : d);
    };
    const int fl = local(bounds.fw_lo), fh = local(bounds.fw_hi);
    const int rl = local(bounds.rv_lo), rh = local(bounds.rv_hi);
    const int lim = static_cast<int>(n - base < kTile ? n - base : kTile);
    int64_t* __restrict__ fw_out = out + base;
    int64_t* __restrict__ rv_out = out + n + base;
    const int64_t plane = 2 * n;
    uint32_t emitted = 0;
#pragma unroll
    for (int r = 0; r < kTile / kPackThreads; ++r) {
        const int p = 32 * (r * kPackWarps + warp) + lane;
        if (p < lim) {
            const int f = p % 3, j = p / 3;
            const uint32_t* bw = tile.bad[f];
            const bool ok = !(__funnelshift_r(bw[j >> 5], bw[(j >> 5) + 1], j & 31) & kmask);
            const bool ef = ok && p >= fl && p < fh;
            const bool er = ok && p >= rl && p < rh;
            emitted += ef + er;
            uint32_t fw[L], rv[L];
            slice(tile.aaFr[f], kJ - j - K, mask, fw);
            slice(tile.aaR[f], j, mask, rv);
#pragma unroll
            for (int q = 0; q < W; ++q) {
                const int64_t off = (W - 1 - q) * plane + p;
                fw_out[off] = ef ? static_cast<int64_t>(word62(fw, q)) : KMERS_SENTINEL;
                rv_out[off] = er ? static_cast<int64_t>(word62(rv, q)) : KMERS_SENTINEL;
            }
        }
    }
    // one atomic a block: at most 2 kTile windows, the sums fit 32 bits
    emitted = __reduce_add_sync(~0u, emitted);
    if (lane == 0) tile.packed.totals[warp] = emitted;
    __syncthreads();
    if (warp == 0) {
        emitted = __reduce_add_sync(~0u, lane < kPackWarps ? tile.packed.totals[lane] : 0u);
        if (lane == 0 && emitted)
            atomicAdd(n_valid, static_cast<unsigned long long>(emitted));
    }
}

template <int W>
int launch(const void* bytes, long long n, int K, long long fw_lo,
           long long fw_hi, long long rv_lo, long long rv_hi, const void* tbl16,
           void* out, void* n_valid, void* stream) {
    if (n > 0) {
        DualTable table;
        const auto* src = static_cast<const uint16_t*>(tbl16);
        for (int c = 0; c < 64; ++c) table.v[c] = src[c];
        const long long blocks = (n + kTile - 1) / kTile;
        sixframe_kernel<W><<<static_cast<unsigned>(blocks), kPackThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(bytes), n, K,
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
    return launch<1>(bytes, n, K, fw_lo, fw_hi, rv_lo, rv_hi, tbl16, keys,
                     n_valid, stream);
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
    auto run = W == 2 ? launch<2> : W == 3 ? launch<3> : W == 4 ? launch<4> : launch<5>;
    return run(bytes, n, K, fw_lo, fw_hi, rv_lo, rv_hi, tbl16, words, n_valid, stream);
}
