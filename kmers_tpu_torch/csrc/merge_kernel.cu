// K9: merge of two sorted count tables (one-word keys, its merge-reduce, and
// its word instance k9w over W word planes), and K10: front-packing (stream
// compaction) of a count table.  The one-word table fold (ops/count.py
// merge_compact_tables) is K9's merge-reduce alone; the word fold
// (ops/multiword.py merge_compact_tables_mw) is the word instance, the
// weighted RLE and K10.  Every counting path runs one of them after its
// chunks, and K10 front-packs every chunk table before the fold.
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
// K9's merge-reduce (k9_reduce_kernel) replaces the three stages the fold
// ran after the merge (the weighted RLE's ~15 torch launches with a binary
// search a row, then K10's three launches), which read the merged stream
// about six more times.  It takes K9's partition launch (at its own tile of
// 2,048 rows; the launch also clears the status words) and one launch more.
// Each block of 128 threads takes its tile by an atomic ticket, in launch
// order, fetches into L2 the input of the tile kReduceAhead tickets on, and
// merges its own as k9_merge_kernel does; then it marks run heads (a
// key unlike the merged row before it; for the tile's first row that is the
// larger of A[a0 - 1] and B[b0 - 1]), sums each head's run from registers
// and shared memory, and finishes the run that reaches the tile's end by
// reading on in A from a1 and in B from b1 (32 rows of each are staged with
// the tile, one warp reads on from there: the common case is one row of
// each, a run of any length stays right).  It keeps the runs with a
// non-sentinel key and a total > 0, ranks them by a block scan, publishes
// its count, packs its kept rows in shared memory, and finds its output
// offset by a single-pass decoupled look-back over the tiles' status words.
// It writes its kept rows front-packed from that offset and its holes
// (merged rows not kept) as sentinel/0 at the table's end, both with
// 16-byte stores, and adds its runs to the distinct count.  So each merged
// row is read once and each output position written once: 32 bytes a merged
// row, K9's own bound.  What it loses against that bound is the look-back's
// wait for the slowest earlier tile still in flight (see kReduceThreads).
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
#include "lookback.cuh"
#include "merge_path.cuh"

namespace {

using kmers::kAggregate;
using kmers::kPrefix;
using kmers::look_back;
using kmers::publish;
using kmers::warp_sum;

constexpr int kCompactThreads = 256;
constexpr int kCompactItems = 8;
constexpr int kCompactTile = kCompactThreads * kCompactItems;  // rows a block
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kScanThreads = 1024;

// co-ranks of every tile of `tile` outputs; for the merge-reduce (`clear`
// set) also its tiles' status words, its ticket and its distinct count, set
// to 0
__global__ void __launch_bounds__(kmers::kMergeThreads)
k9_partition_kernel(kmers::MergeSpec s, int64_t tiles, int64_t* __restrict__ corank,
                    int64_t tile, unsigned long long* __restrict__ clear) {
    const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (clear != nullptr && g < tiles + 2) clear[g] = 0;
    kmers::merge_partition(s, tiles, corank, tile);
}

__global__ void __launch_bounds__(kmers::kMergeThreads, 3)
k9_merge_kernel(kmers::MergeSpec s, const int64_t* __restrict__ corank) {
    extern __shared__ int64_t smem[];
    kmers::merge_tile<true>(s, corank, smem, smem + kmers::kMergePlane);
}

// The merge-reduce's block: 128 threads of kMergeItems rows.  A tile of
// 2,048 rows stages 34 KB of shared memory, so six blocks share an SM: a
// tile waits in the look-back for the slowest of the tiles before it that
// are still in flight (~35 % of its time at 47 M rows), and the more blocks
// an SM holds, the more of that wait the others cover.
constexpr int kReduceThreads = 128;
constexpr int kReduceBlocks = 6;
constexpr int kReduceTile = kReduceThreads * kmers::kMergeItems;
constexpr int kReducePlane = kmers::merge_plane(kReduceTile);
constexpr int kReduceWarps = kReduceThreads / 32;
// Each block fetches into L2 the input of the tile kReduceAhead tickets on,
// so that tile's staging finds it there: on an H100 at 47 M rows, 32 to 128
// tickets ahead took the kernel 757 to 670–690 µs, 256 ahead 740, 512 903.
constexpr int64_t kReduceAhead = 64;

// By a whole warp: the counts of the rows of keys[i0, n) equal to `key`,
// summed (in a sorted table they are one run from i0 on), 32 rows a step.
__device__ __forceinline__ unsigned long long run_from(const int64_t* __restrict__ keys,
                                                       const int64_t* __restrict__ counts,
                                                       int64_t i0, int64_t n, int64_t key) {
    const int lane = threadIdx.x & 31;
    unsigned long long sum = 0;
    for (int64_t i = i0; i < n; i += 32) {
        const int64_t p = i + lane;
        const bool eq = p < n && keys[p] == key;
        if (eq) sum += static_cast<unsigned long long>(counts[p]);
        if (__ballot_sync(0xFFFFFFFFu, eq) != 0xFFFFFFFFu) break;
    }
    return warp_sum(sum);
}

// The input rows of tile h (keys and counts of its A and B ranges) fetched
// into L2 by the block, one 128-byte line a thread at a time.
__device__ __forceinline__ void prefetch_tile(const kmers::MergeSpec& s,
                                              const int64_t* __restrict__ corank, int64_t h) {
    const int64_t e0 = h * kReduceTile;
    if (e0 >= s.n) return;
    const int64_t e1 = kmers::imin64(e0 + kReduceTile, s.n);
    const int64_t a0 = corank[h], a1 = e1 == s.n ? s.na : corank[h + 1];
    const int64_t b0 = e0 - a0, b1 = e1 - a1;
    const int64_t* base[4] = {s.a + a0, s.ca + a0, s.b + b0, s.cb + b0};
    const int64_t rows[4] = {a1 - a0, a1 - a0, b1 - b0, b1 - b0};
#pragma unroll
    for (int q = 0; q < 4; ++q)
        for (int64_t o = threadIdx.x * 16; o < rows[q]; o += kReduceThreads * 16)
            asm volatile("prefetch.global.L2 [%0];" ::"l"(base[q] + o));
}

// an 8-byte asynchronous copy to shared memory (waited for with the tile's)
__device__ __forceinline__ void copy8(int64_t* dst, const int64_t* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(kmers::smem_addr(dst)), "l"(src));
}

// dst[0, len) = v with 16-byte stores from dst's first 16-byte boundary on.
__device__ __forceinline__ void fill_range(int64_t* __restrict__ dst, int len, int64_t v) {
    const int t = threadIdx.x;
    const int head = (reinterpret_cast<uintptr_t>(dst) & 15) && len > 0 ? 1 : 0;
    if (head && t == 0) dst[0] = v;
    longlong2* w = reinterpret_cast<longlong2*>(dst + head);
    const int pairs = (len - head) >> 1;
    for (int q = t; q < pairs; q += kReduceThreads) w[q] = make_longlong2(v, v);
    if (((len - head) & 1) && t == 0) dst[len - 1] = v;
}

// K9's merge-reduce of one pair (s.stride unused): status, ticket and
// n_unique are the partition launch's cleared words.
__global__ void __launch_bounds__(kReduceThreads, kReduceBlocks)
k9_reduce_kernel(kmers::MergeSpec s, const int64_t* __restrict__ corank,
                 unsigned long long* __restrict__ status, unsigned long long* __restrict__ ticket,
                 unsigned long long* __restrict__ n_unique) {
    constexpr int kItems = kmers::kMergeItems;
    extern __shared__ int64_t smem[];
    __shared__ int64_t s_tile;
    __shared__ unsigned long long s_beyond, s_off;
    __shared__ int s_kept[kReduceWarps], s_runs[kReduceWarps];
    // staged with the tile (loaded by one warp after the merge instead, they
    // cost the kernel ~4 % on an H100): A[a0 - 1] and B[b0 - 1]; the 32 rows
    // of A from a1 and of B from b1 (keys, then counts)
    __shared__ int64_t s_before[2];
    __shared__ int64_t s_next[4][32];
    int64_t* keys = smem;
    int64_t* vals = smem + kReducePlane;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) s_tile = static_cast<int64_t>(atomicAdd(ticket, 1ull));
    __syncthreads();
    const int64_t g = s_tile;
    const int64_t d0 = g * kReduceTile;
    const int64_t d1 = kmers::imin64(d0 + kReduceTile, s.n);
    if (warp == 0) {
        const int64_t a0 = corank[g], a1 = d1 == s.n ? s.na : corank[g + 1];
        const int64_t b0 = d0 - a0, b1 = d1 - a1;
        if (lane == 0 && a0 > 0) copy8(&s_before[0], s.a + a0 - 1);
        if (lane == 1 && b0 > 0) copy8(&s_before[1], s.b + b0 - 1);
        if (a1 + lane < s.na) {
            copy8(&s_next[0][lane], s.a + a1 + lane);
            copy8(&s_next[1][lane], s.ca + a1 + lane);
        }
        if (b1 + lane < s.nb) {
            copy8(&s_next[2][lane], s.b + b1 + lane);
            copy8(&s_next[3][lane], s.cb + b1 + lane);
        }
    }
    prefetch_tile(s, corank, g + kReduceAhead);
    int64_t k[kItems], v[kItems];
    const kmers::TileRange r =
        kmers::merge_tile_to_shared<true, kReduceThreads>(s, g, corank, keys, vals, k, v);
    const int local = threadIdx.x * kItems;
    const int cnt = local < r.len ? min(kItems, r.len - local) : 0;

    // (1) run heads: rows whose key differs from the merged row before them;
    // before the tile's first row, the larger of A[a0 - 1] and B[b0 - 1]
    unsigned head = 0;
    int64_t last = k[0];  // the key of this thread's last row
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        if (j < cnt) {
            bool h;
            if (j > 0) {
                h = k[j] != k[j > 0 ? j - 1 : 0];
            } else if (local > 0) {
                h = k[0] != keys[kmers::padded(local - 1)];
            } else if (g == 0) {
                h = true;
            } else {
                const int64_t a = r.a0 > 0 ? s_before[0] : s_before[1];
                const int64_t b = r.b0 > 0 ? s_before[1] : a;
                h = k[0] != (a > b ? a : b);
            }
            head |= (h ? 1u : 0u) << j;
            last = k[j];
        }
    }
    // (2) what the last run of a thread with a head sums beyond its rows, in
    // the tile; and, by warp 0, what the tile's last run sums beyond the tile
    unsigned long long beyond = 0;
    bool open = false;
    if (head && last != KMERS_SENTINEL) {
        int p = local + cnt;
        for (; p < r.len && keys[kmers::padded(p)] == last; ++p)
            beyond += static_cast<unsigned long long>(vals[kmers::padded(p)]);
        open = p == r.len;
    }
    if (warp == 0) {
        const int64_t tail = keys[kmers::padded(r.len - 1)];
        unsigned long long past = 0;
        if (tail != KMERS_SENTINEL) {
            const bool in_a = r.a1 + lane < s.na && s_next[0][lane] == tail;
            const bool in_b = r.b1 + lane < s.nb && s_next[2][lane] == tail;
            past = warp_sum((in_a ? static_cast<unsigned long long>(s_next[1][lane]) : 0ull) +
                            (in_b ? static_cast<unsigned long long>(s_next[3][lane]) : 0ull));
            // a run on past the 32 staged rows: read on in device memory
            if (__all_sync(0xFFFFFFFFu, in_a)) past += run_from(s.a, s.ca, r.a1 + 32, s.na, tail);
            if (__all_sync(0xFFFFFFFFu, in_b)) past += run_from(s.b, s.cb, r.b1 + 32, s.nb, tail);
        }
        if (lane == 0) s_beyond = past;
    }
    __syncthreads();

    // (3) run totals, from the thread's last row back, into v; a head's
    // total is its run's sum (mod 2^64, as the weighted RLE's cumsum)
    const unsigned long long carry = beyond + (open ? s_beyond : 0ull);
    unsigned long long acc = 0;
    unsigned kept = 0;
    int runs = 0;
#pragma unroll
    for (int j = kItems - 1; j >= 0; --j) {
        if (j < cnt) {
            const bool joins = j + 1 < cnt && k[j + 1 < kItems ? j + 1 : j] == k[j];
            acc = (j == cnt - 1 ? carry : joins ? acc : 0ull) + static_cast<unsigned long long>(v[j]);
            v[j] = static_cast<int64_t>(acc);
            if ((head >> j & 1u) && k[j] != KMERS_SENTINEL) {
                ++runs;
                if (v[j] > 0) kept |= 1u << j;
            }
        }
    }
    // (4) the kept rows' ranks in the tile, and the tile's runs
    const int c = __popc(kept);
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += y;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) runs += __shfl_xor_sync(0xFFFFFFFFu, runs, o);
    if (lane == 31) s_kept[warp] = incl;
    if (lane == 0) s_runs[warp] = runs;
    __syncthreads();
    int rank = incl - c, total = 0, tile_runs = 0;
#pragma unroll
    for (int w = 0; w < kReduceWarps; ++w) {
        rank += w < warp ? s_kept[w] : 0;
        total += s_kept[w];
        tile_runs += s_runs[w];
    }
    // (5) the tile's count published; its kept rows packed in shared memory
    // (no thread reads the merged tile after the barrier of (2))
    if (threadIdx.x == 0) {
        publish(status + g, (g == 0 ? kPrefix : kAggregate) | static_cast<unsigned long long>(total));
        if (tile_runs) atomicAdd(n_unique, static_cast<unsigned long long>(tile_runs));
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        if (kept >> j & 1u) {
            keys[kmers::padded(rank)] = k[j];
            vals[kmers::padded(rank)] = v[j];
            ++rank;
        }
    }
    // (6) the tile's offset by the look-back; then its kept rows written out
    // from there, and its holes over the table's tail from its end back
    if (warp == 0) {
        const unsigned long long off = g == 0 ? 0ull : look_back(status, g);
        if (lane == 0) {
            if (g > 0) publish(status + g, kPrefix | (off + total));
            s_off = off;
        }
    }
    __syncthreads();
    const int64_t off = static_cast<int64_t>(s_off);
    kmers::store_range<kItems, kReduceThreads>(s.out + off, total, keys);
    kmers::store_range<kItems, kReduceThreads>(s.out_c + off, total, vals);
    const int holes = r.len - total;
    const int64_t hole0 = s.n - (d0 - off) - holes;
    fill_range(s.out + hole0, holes, KMERS_SENTINEL);
    fill_range(s.out_c + hole0, holes, 0);
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
        s, tiles, corank, kmers::kMergeTile, nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    k9_merge_kernel<<<static_cast<unsigned>(tiles), kmers::kMergeThreads, smem, st>>>(s, corank);
    return static_cast<int>(cudaGetLastError());
}

// Rows a block of K9's merge-reduce owns
// (kmers_tpu_torch/ops/kernels/merge_kernel.py merge_reduce_tables).
extern "C" int k9_reduce_tile() { return kReduceTile; }

// K9's merge-reduce.  keys, counts: int64[na + nb], 16-byte aligned: the
// merge of (ka, ca) and (kb, cb), each sorted ascending by key, with equal
// keys summed; the runs whose key is not the sentinel and whose total is
// > 0 front-packed in key order, then sentinel/0.  scratch: int64[2 tiles +
// 2], tiles = ceil((na + nb) / k9_reduce_tile()): the co-ranks, the tiles'
// status words, the ticket, and last the number of runs whose key is not the
// sentinel (kept or not), which the kernel writes.
extern "C" int k9_merge_reduce_tables(const void* ka, const void* ca, long long na,
                                      const void* kb, const void* cb, long long nb,
                                      void* scratch, long long tiles, void* keys,
                                      void* counts, void* stream) {
    const long long n = na + nb;
    if (na < 0 || nb < 0 || tiles != (n + kReduceTile - 1) / kReduceTile ||
        !kmers::aligned16(keys) || !kmers::aligned16(counts))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return static_cast<int>(cudaGetLastError());
    const auto st = static_cast<cudaStream_t>(stream);
    kmers::MergeSpec s{static_cast<const int64_t*>(ka), static_cast<const int64_t*>(kb),
                       static_cast<const int64_t*>(ca), static_cast<const int64_t*>(cb),
                       na, nb, 0, n, static_cast<int64_t*>(keys),
                       static_cast<int64_t*>(counts)};
    auto* corank = static_cast<int64_t*>(scratch);
    auto* status = reinterpret_cast<unsigned long long*>(corank + tiles);
    const size_t smem = 2 * kReducePlane * sizeof(int64_t);
    cudaError_t err = cudaFuncSetAttribute(
        k9_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    // one thread a tile, and two more for the ticket and the distinct count
    const long long part_blocks = (tiles + 2 + kmers::kMergeThreads - 1) / kmers::kMergeThreads;
    k9_partition_kernel<<<static_cast<unsigned>(part_blocks), kmers::kMergeThreads, 0, st>>>(
        s, tiles, corank, kReduceTile, status);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    k9_reduce_kernel<<<static_cast<unsigned>(tiles), kReduceThreads, smem, st>>>(
        s, corank, status, status + tiles, status + tiles + 1);
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
