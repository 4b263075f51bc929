// K9: merge of two sorted count tables (one-word keys, and its word
// instance k9w over W word planes), and K10: front-packing (stream
// compaction) of a count table.  Together with the weighted RLE between
// them they make up the device table fold (ops/count.py
// merge_compact_tables; ops/multiword.py merge_compact_tables_mw for word
// tables), which every counting path runs after its chunks.
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
// so both are bound by device memory (3.35 TB/s).
//
// K9 design: the partitioned merge path of merge_path.cuh, with the counts
// as its payload, in two launches.  k9_partition_kernel finds the co-rank of
// every tile's first output (A first on ties) with one thread a tile, so
// thousands of threads hide the ~26 dependent loads of the search over the
// whole tables; k9_merge_kernel stages each tile's A and B ranges (keys and
// counts, one tile of rows in all) in shared memory with 16-byte cp.async,
// merges from there into registers (kMergeItems = 16 outputs a thread,
// 4,096 a block, 68 KB of shared memory, three blocks an SM) and writes the
// tile out with 16-byte stores.  Every row is read from device memory once,
// coalesced, and written once; only the co-ranks are read twice.  Indices
// are int64: two 2^30-row tables fit on an 80 GB card.
//
// K9's word instance (k9w_*, W = 2..5 words a key): the same partitioned
// merge path over tables of W word planes, counts as the payload, rows
// compared lexicographically (merge_path.cuh, WordMergeSpec).  It replaces
// the stable lexicographic re-sort of the concatenated tables that the word
// fold (ops/multiword.py merge_compact_tables_mw) ran before; the JAX
// package's counterpart is kmers_tpu/ops/multiword.py merge_compact_tables_mw,
// a multi-limb bitonic merge network.  Bound by device memory as K9: a
// two-word row is 24 bytes read once and written once.  Each input's word
// planes take their own stride, so a table cut to its live rows is merged
// without a copy.  A block stages W + 1 planes of a tile of 2,048 rows
// (1,024 beyond W = 3): at W = 2 that is 55 KB, three blocks an SM.
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
#include "merge_path.cuh"

namespace {

constexpr int kCompactThreads = 256;
constexpr int kCompactItems = 8;
constexpr int kCompactTile = kCompactThreads * kCompactItems;  // rows a block
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kmers::kMergeThreads)
k9_partition_kernel(kmers::MergeSpec s, int64_t tiles, int64_t* __restrict__ corank) {
    kmers::merge_partition(s, tiles, corank);
}

__global__ void __launch_bounds__(kmers::kMergeThreads, 3)
k9_merge_kernel(kmers::MergeSpec s, const int64_t* __restrict__ corank) {
    extern __shared__ int64_t smem[];
    kmers::merge_tile<true>(s, corank, smem, smem + kmers::kMergePlane);
}

template <int W>
__global__ void __launch_bounds__(kmers::kMergeThreads)
k9w_partition_kernel(kmers::WordMergeSpec s, int64_t tiles, int64_t* __restrict__ corank) {
    kmers::word_merge_partition<W>(s, tiles, corank);
}

template <int W>
__global__ void __launch_bounds__(kmers::kMergeThreads, 2)
k9w_merge_kernel(kmers::WordMergeSpec s, const int64_t* __restrict__ corank) {
    extern __shared__ int64_t smem[];
    kmers::word_merge_tile<W>(s, corank, smem);
}

template <int W>
int launch_word_merge(const kmers::WordMergeSpec& s, int64_t* corank, long long tiles,
                      cudaStream_t st) {
    const size_t smem = kmers::word_merge_smem(W);
    cudaError_t err = cudaFuncSetAttribute(
        k9w_merge_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long part_blocks = (tiles + kmers::kMergeThreads - 1) / kmers::kMergeThreads;
    k9w_partition_kernel<W><<<static_cast<unsigned>(part_blocks), kmers::kMergeThreads, 0, st>>>(
        s, tiles, corank);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    k9w_merge_kernel<W><<<static_cast<unsigned>(tiles), kmers::kMergeThreads, smem, st>>>(s, corank);
    return static_cast<int>(cudaGetLastError());
}

bool word_instance(int words) { return words >= 2 && words <= 5; }

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
    const int64_t end = kmers::imin64(begin + per, m);
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

// Outputs a K9 block owns (kmers_tpu_torch/ops/kernels/merge_kernel.py
// MERGE_TILE): k9_merge_tables takes ceil((na + nb) / k9_merge_tile())
// int64 of scratch.
extern "C" int k9_merge_tile() { return kmers::kMergeTile; }

// keys, counts: int64[na + nb], 16-byte aligned, the merge of (ka, ca) and
// (kb, cb), each sorted ascending by key; scratch: int64[tiles], tiles =
// ceil((na + nb) / k9_merge_tile()).
extern "C" int k9_merge_tables(const void* ka, const void* ca, long long na,
                               const void* kb, const void* cb, long long nb,
                               void* scratch, long long tiles, void* keys,
                               void* counts, void* stream) {
    const long long n = na + nb;
    if (na < 0 || nb < 0 || tiles != kmers::merge_tiles(n) || !kmers::aligned16(keys) ||
        !kmers::aligned16(counts))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return static_cast<int>(cudaGetLastError());
    const auto st = static_cast<cudaStream_t>(stream);
    kmers::MergeSpec s{static_cast<const int64_t*>(ka), static_cast<const int64_t*>(kb),
                       static_cast<const int64_t*>(ca), static_cast<const int64_t*>(cb),
                       na, nb, 0, n, static_cast<int64_t*>(keys),
                       static_cast<int64_t*>(counts)};
    auto* corank = static_cast<int64_t*>(scratch);
    const size_t smem = kmers::merge_smem(true);
    cudaError_t err = cudaFuncSetAttribute(
        k9_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long part_blocks = (tiles + kmers::kMergeThreads - 1) / kmers::kMergeThreads;
    k9_partition_kernel<<<static_cast<unsigned>(part_blocks), kmers::kMergeThreads, 0, st>>>(
        s, tiles, corank);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    k9_merge_kernel<<<static_cast<unsigned>(tiles), kmers::kMergeThreads, smem, st>>>(s, corank);
    return static_cast<int>(cudaGetLastError());
}

// Outputs a k9w block owns at W words a key; 0 for a W with no instance.
extern "C" int k9w_merge_tile(int words) {
    return word_instance(words) ? kmers::word_tile(words) : 0;
}

// keys: int64[words, na + nb] (planes na + nb apart, 16-byte aligned),
// counts: int64[na + nb] (16-byte aligned), the merge of (ka, ca) and
// (kb, cb), each sorted lexicographically by its words; word w of A's row i
// is ka[w * a_stride + i], its count ca[i] (B alike); scratch:
// int64[tiles], tiles = ceil((na + nb) / k9w_merge_tile(words)).
extern "C" int k9w_merge_tables(int words, const void* ka, long long a_stride,
                                const void* ca, long long na, const void* kb,
                                long long b_stride, const void* cb, long long nb,
                                void* scratch, long long tiles, void* keys,
                                void* counts, void* stream) {
    const long long n = na + nb;
    if (!word_instance(words) || na < 0 || nb < 0 || a_stride < 0 || b_stride < 0 ||
        tiles != kmers::word_merge_tiles(words, n) || !kmers::aligned16(keys) ||
        !kmers::aligned16(counts))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return static_cast<int>(cudaGetLastError());
    const auto st = static_cast<cudaStream_t>(stream);
    const kmers::WordMergeSpec s{static_cast<const int64_t*>(ka), static_cast<const int64_t*>(kb),
                                 static_cast<const int64_t*>(ca), static_cast<const int64_t*>(cb),
                                 a_stride, b_stride, na, nb, static_cast<int64_t*>(keys),
                                 static_cast<int64_t*>(counts)};
    auto* corank = static_cast<int64_t*>(scratch);
    switch (words) {
        case 2: return launch_word_merge<2>(s, corank, tiles, st);
        case 3: return launch_word_merge<3>(s, corank, tiles, st);
        case 4: return launch_word_merge<4>(s, corank, tiles, st);
        default: return launch_word_merge<5>(s, corank, tiles, st);
    }
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
