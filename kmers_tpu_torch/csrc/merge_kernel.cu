// K9: merge of two sorted count tables, and K10: front-packing (stream
// compaction) of a count table.  Together with the weighted RLE between
// them they make up the device table fold (ops/count.py
// merge_compact_tables), which every counting path runs after its chunks.
//
// K9 replaces the TPU kernel kmers_tpu/ops/pallas/merge_kernel.py
// bitonic_merge_tail_pallas (_kernel): the in-tile compare-exchange steps of
// a bitonic merge network.  The function that network computes is the
// sorted merge of two sorted tables with counts moving with their keys, and
// that is what K9 computes, by merge path rather than by a network.
//
// K10 replaces kmers_tpu/ops/pallas/merge_kernel.py compact_tail_pallas
// (_kernel_compact): the in-tile passes of a log-shift compaction network.
// Its function is stream compaction: the rows with count > 0 move to the
// front in order, and the tail becomes sentinel/0.
//
// What bounds them on an H100: both read each input row once and write each
// output row once (16 bytes a one-word row), with O(log) integer work a row,
// so both are bound by device memory.
//
// K9 design: the TPU network's strides fit its (8, W) tiles; on Hopper a
// merge path needs no network.  Each block owns kMergeTile consecutive
// output positions.  Two threads find the block's co-ranks (how many rows of
// A precede its first and its last output, A first on ties) by binary search
// over the whole tables; every thread then searches only inside the block's
// ranges for the co-rank of its own first output, merges its kMergeItems
// outputs sequentially into shared memory, and the block writes them out
// coalesced.  Indices are int64: two 2^30-row tables fit on an 80 GB card.
//
// K10 design: the TPU kernel carried "tile plus next tile" state from one
// grid step to the next; CUDA blocks run in no order, so compaction takes
// three launches: (1) each block counts the real rows of its tile, (2) one
// block scans the tile totals exclusively and writes the grand total, (3)
// each block ranks its real rows (a warp ballot and popcount, then the warp
// totals in shared memory) and writes each row's words and count to its
// tile offset plus rank; output positions at or past the grand total get
// the sentinel in every word and count 0.  Word planes of a (W, n) table
// are strided by n and move together.
#include "common.cuh"

namespace {

constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 8;
constexpr int kMergeTile = kMergeThreads * kMergeItems;  // outputs a block

constexpr int kCompactThreads = 256;
constexpr int kCompactItems = 8;
constexpr int kCompactTile = kCompactThreads * kCompactItems;  // rows a block
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

// The number of rows of A among the first d outputs of the merge, A first
// on ties: the least i in [lo, hi] with a[i] > b[d - i - 1].  The caller
// keeps max(0, d - nb) <= lo <= hi <= min(d, na), so every index read is in
// range.
__device__ __forceinline__ int64_t co_rank(const int64_t* __restrict__ a,
                                           const int64_t* __restrict__ b,
                                           int64_t d, int64_t lo, int64_t hi) {
    while (lo < hi) {
        const int64_t mid = lo + (hi - lo) / 2;
        if (a[mid] <= b[d - mid - 1]) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__global__ void __launch_bounds__(kMergeThreads)
merge_tables_kernel(const int64_t* __restrict__ ka, const int64_t* __restrict__ ca,
                    int64_t na, const int64_t* __restrict__ kb,
                    const int64_t* __restrict__ cb, int64_t nb,
                    int64_t* __restrict__ keys, int64_t* __restrict__ counts) {
    __shared__ int64_t s_keys[kMergeTile];
    __shared__ int64_t s_counts[kMergeTile];
    __shared__ int64_t s_split[2];
    const int64_t n = na + nb;
    const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kMergeTile;
    const int64_t tile1 = imin(tile0 + kMergeTile, n);
    if (threadIdx.x < 2) {
        const int64_t d = threadIdx.x ? tile1 : tile0;
        s_split[threadIdx.x] = co_rank(ka, kb, d, imax(0, d - nb), imin(d, na));
    }
    __syncthreads();
    // the block merges a[a0, a1) with b[b0, b1)
    const int64_t a0 = s_split[0], a1 = s_split[1];
    const int64_t b0 = tile0 - a0, b1 = tile1 - a1;
    const int local = threadIdx.x * kMergeItems;
    const int64_t d = tile0 + local;
    if (d < tile1) {
        int64_t i = co_rank(ka, kb, d, imax(a0, d - b1), imin(a1, d - b0));
        int64_t j = d - i;
        const int m = static_cast<int>(imin(kMergeItems, tile1 - d));
        for (int k = 0; k < m; ++k) {
            const bool take_a = j >= b1 || (i < a1 && ka[i] <= kb[j]);
            if (take_a) {
                s_keys[local + k] = ka[i];
                s_counts[local + k] = ca[i];
                ++i;
            } else {
                s_keys[local + k] = kb[j];
                s_counts[local + k] = cb[j];
                ++j;
            }
        }
    }
    __syncthreads();
    for (int64_t t = threadIdx.x; t < tile1 - tile0; t += kMergeThreads) {
        keys[tile0 + t] = s_keys[t];
        counts[tile0 + t] = s_counts[t];
    }
}

// (1) real rows (count > 0) of each tile
__global__ void __launch_bounds__(kCompactThreads)
compact_count_kernel(const int64_t* __restrict__ counts, int64_t n,
                     int64_t* __restrict__ tile_totals) {
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kCompactTile;
    int total = 0;
    for (int k = 0; k < kCompactItems; ++k) {
        const int64_t r = base + k * kCompactThreads + threadIdx.x;
        total += __syncthreads_count(r < n && counts[r] > 0);
    }
    if (threadIdx.x == 0) tile_totals[blockIdx.x] = total;
}

// (2) exclusive scan of the m tile totals by one block, and the grand total
__global__ void __launch_bounds__(kScanThreads)
compact_scan_kernel(const int64_t* __restrict__ tile_totals, int64_t m,
                    int64_t* __restrict__ offsets, int64_t* __restrict__ total) {
    __shared__ int64_t s[kScanThreads];
    const int64_t per = (m + kScanThreads - 1) / kScanThreads;
    const int64_t begin = threadIdx.x * per;
    const int64_t end = imin(begin + per, m);
    int64_t sum = 0;
    for (int64_t i = begin; i < end; ++i) sum += tile_totals[i];
    s[threadIdx.x] = sum;
    __syncthreads();
    for (int off = 1; off < kScanThreads; off <<= 1) {
        const int64_t v = threadIdx.x >= off ? s[threadIdx.x - off] : 0;
        __syncthreads();
        s[threadIdx.x] += v;
        __syncthreads();
    }
    int64_t run = s[threadIdx.x] - sum;
    for (int64_t i = begin; i < end; ++i) {
        offsets[i] = run;
        run += tile_totals[i];
    }
    if (threadIdx.x == kScanThreads - 1) *total = s[kScanThreads - 1];
}

// (3) each real row to its tile offset plus its rank in the tile; the
// positions from the grand total on become sentinel/0
__global__ void __launch_bounds__(kCompactThreads)
compact_scatter_kernel(const int64_t* __restrict__ keys,
                       const int64_t* __restrict__ counts, int64_t n, int words,
                       const int64_t* __restrict__ offsets,
                       const int64_t* __restrict__ total,
                       int64_t* __restrict__ out_keys,
                       int64_t* __restrict__ out_counts) {
    __shared__ int warp_totals[kCompactWarps];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kCompactTile;
    const int64_t grand = *total;
    int64_t dest = offsets[blockIdx.x];
    for (int k = 0; k < kCompactItems; ++k) {
        const int64_t r = base + k * kCompactThreads + threadIdx.x;
        const bool in = r < n;
        const bool real = in && counts[r] > 0;
        const unsigned ballot = __ballot_sync(0xFFFFFFFFu, real);
        if (lane == 0) warp_totals[warp] = __popc(ballot);
        __syncthreads();
        int before = 0, all = 0;
        for (int w = 0; w < kCompactWarps; ++w) {
            const int t = warp_totals[w];
            before += w < warp ? t : 0;
            all += t;
        }
        if (real) {
            const int64_t o = dest + before + __popc(ballot & ((1u << lane) - 1u));
            for (int w = 0; w < words; ++w)
                out_keys[static_cast<int64_t>(w) * n + o] = keys[static_cast<int64_t>(w) * n + r];
            out_counts[o] = counts[r];
        }
        if (in && r >= grand) {
            for (int w = 0; w < words; ++w)
                out_keys[static_cast<int64_t>(w) * n + r] = KMERS_SENTINEL;
            out_counts[r] = 0;
        }
        dest += all;
        __syncthreads();  // warp_totals is rewritten by the next round
    }
}

}  // namespace

// keys, counts: int64[na + nb], the merge of (ka, ca) and (kb, cb), each
// sorted ascending by key.
extern "C" int k9_merge_tables(const void* ka, const void* ca, long long na,
                               const void* kb, const void* cb, long long nb,
                               void* keys, void* counts, void* stream) {
    const long long n = na + nb;
    if (n > 0) {
        const long long blocks = (n + kMergeTile - 1) / kMergeTile;
        merge_tables_kernel<<<static_cast<unsigned>(blocks), kMergeThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int64_t*>(ka), static_cast<const int64_t*>(ca), na,
            static_cast<const int64_t*>(kb), static_cast<const int64_t*>(cb), nb,
            static_cast<int64_t*>(keys), static_cast<int64_t*>(counts));
    }
    return static_cast<int>(cudaGetLastError());
}

// The int64 elements of k10_compact_table's scratch for n rows: the tile
// totals, the tile offsets and the grand total.
extern "C" long long k10_scratch_elems(long long n) {
    return 2 * ((n + kCompactTile - 1) / kCompactTile) + 1;
}

// keys: int64[words, n] (word planes strided by n), counts: int64[n];
// scratch: int64[k10_scratch_elems(n)]; out_keys, out_counts: the shapes of
// keys and counts.
extern "C" int k10_compact_table(const void* keys, const void* counts, long long n,
                                 int words, void* scratch, void* out_keys,
                                 void* out_counts, void* stream) {
    if (n <= 0) return static_cast<int>(cudaGetLastError());
    const long long tiles = (n + kCompactTile - 1) / kCompactTile;
    const auto s = static_cast<cudaStream_t>(stream);
    int64_t* tile_totals = static_cast<int64_t*>(scratch);
    int64_t* offsets = tile_totals + tiles;
    int64_t* total = offsets + tiles;
    compact_count_kernel<<<static_cast<unsigned>(tiles), kCompactThreads, 0, s>>>(
        static_cast<const int64_t*>(counts), n, tile_totals);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    compact_scan_kernel<<<1, kScanThreads, 0, s>>>(tile_totals, tiles, offsets, total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    compact_scatter_kernel<<<static_cast<unsigned>(tiles), kCompactThreads, 0, s>>>(
        static_cast<const int64_t*>(keys), static_cast<const int64_t*>(counts), n,
        words, offsets, total, static_cast<int64_t*>(out_keys),
        static_cast<int64_t*>(out_counts));
    return static_cast<int>(cudaGetLastError());
}
