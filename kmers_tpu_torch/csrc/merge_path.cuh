// The merge path shared by K9 (the merge of two sorted count tables, and its
// merge-reduce, which sums equal keys in the same pass), K11's merge rounds
// (keys only) and K9's word instance (tables of W word planes, at the end of
// this file): the co-rank search, the staging of a block's input ranges in
// shared memory, the block's merge into registers and its coalesced store.
//
// A merge problem is a row of pairs of ascending runs: pair p merges
// a[p * stride, + na) with b[p * stride, + nb) into out[p * (na + nb), +
// na + nb), A first on equal keys, and a payload (counts) moves with each
// key where kPayload is set.  K9 is one pair; a K11 round is n / (2 run)
// pairs of two runs of `run` keys each, laid side by side (stride 2 run).
// The output is cut into tiles of kMergeTile positions (K9's merge-reduce:
// of its own block's kThreads * kMergeItems).  A tile never straddles two
// pairs (K9 has one; K11's pair length is a multiple of the tile), so a
// tile is one block's work:
//
// 1. merge_partition: one thread per tile finds the co-rank of the tile's
//    first output (how many rows of A precede it) by binary search over its
//    pair's runs in device memory, and writes it to `corank`;
// 2. merge_tile: the block reads its two co-ranks, copies its A range and
//    B range (at most one tile of rows in all) into shared memory with
//    16-byte asynchronous copies (cp.async), each thread finds its own
//    co-rank by binary search in shared memory and merges kMergeItems
//    outputs into registers (merge_tile_to_shared, which the merge-reduce
//    takes up from there), and the block writes them out with 16-byte
//    stores.
#pragma once

#include "common.cuh"

namespace kmers {

constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 16;
constexpr int kMergeTile = kMergeThreads * kMergeItems;  // outputs a block
// shared-memory words of one plane: the output layout has one pad word
// after every kMergeItems words (one thread's outputs), so a warp's
// register-to-shared stores fall on distinct banks
// (the staged A and B ranges take at most kMergeTile + 2 words)
constexpr int kMergePlane = kMergeTile + kMergeTile / kMergeItems;

struct MergeSpec {
    const int64_t* a;   // pair 0's A keys
    const int64_t* b;   // pair 0's B keys
    const int64_t* ca;  // payloads (kPayload only)
    const int64_t* cb;
    int64_t na, nb;     // rows of A and of B in every pair
    int64_t stride;     // elements from pair p's runs to pair p + 1's
    int64_t n;          // outputs of all pairs
    int64_t* out;
    int64_t* out_c;     // (kPayload only)
};

__device__ __forceinline__ int64_t imin64(int64_t a, int64_t b) { return a < b ? a : b; }

// The number of rows of A among the first d outputs of the merge of
// a[0, na) and b[0, nb), A first on ties: the least i in
// [max(0, d - nb), min(d, na)] with a[i] > b[d - i - 1].  Works on device or
// shared memory alike.
template <typename I>
__device__ __forceinline__ I co_rank(const int64_t* a, I na, const int64_t* b, I nb, I d) {
    I lo = d > nb ? d - nb : 0;
    I hi = d < na ? d : na;
    while (lo < hi) {
        const I mid = lo + (hi - lo) / 2;
        if (a[mid] <= b[d - mid - 1]) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// Tile g's pair and its offset in that pair's output, at `tile` outputs a
// tile.
__device__ __forceinline__ void tile_origin(const MergeSpec& s, int64_t g, int64_t& pair,
                                            int64_t& d0, int64_t tile = kMergeTile) {
    const int64_t o0 = g * tile;
    const int64_t len = s.na + s.nb;
    pair = o0 / len;
    d0 = o0 - pair * len;
}

// (1) corank[g] = co-rank of tile g's first output in its pair
__device__ __forceinline__ void merge_partition(const MergeSpec& s, int64_t tiles,
                                                int64_t* __restrict__ corank,
                                                int64_t tile = kMergeTile) {
    const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (g >= tiles) return;
    int64_t pair, d0;
    tile_origin(s, g, pair, d0, tile);
    corank[g] = co_rank<int64_t>(s.a + pair * s.stride, s.na, s.b + pair * s.stride, s.nb, d0);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Where to stage a range that starts at src, at or after dst0 in shared
// memory: dst0, or the next word, whichever agrees with src modulo 16 bytes,
// so that the range copies in 16-byte pieces.
__device__ __forceinline__ int64_t* congruent(int64_t* dst0, const int64_t* src) {
    return dst0 + (((reinterpret_cast<uintptr_t>(dst0) ^ reinterpret_cast<uintptr_t>(src)) >> 3) & 1);
}

// dst[0, len) = src[0, len) by the block of kThreads threads, with
// asynchronous copies (cp.async: no registers, all of a thread's copies in
// flight at once): 16 bytes at a time from the first 16-byte boundary of src
// on.  dst must agree with src modulo 16 bytes (congruent); the caller waits
// with cp_async_wait_all and a barrier.
template <int kThreads = kMergeThreads>
__device__ __forceinline__ void stage_range(const int64_t* __restrict__ src, int len,
                                            int64_t* dst) {
    const int t = threadIdx.x;
    const int head = (reinterpret_cast<uintptr_t>(src) & 15) && len > 0 ? 1 : 0;
    if (head && t == 0)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
    const int pairs = (len - head) >> 1;
    for (int q = t; q < pairs; q += kThreads)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     ::"r"(smem_addr(dst + head + 2 * q)), "l"(src + head + 2 * q));
    if (((len - head) & 1) && t == 0)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                     ::"r"(smem_addr(dst + len - 1)), "l"(src + len - 1));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int padded(int i) { return i + i / kMergeItems; }

// dst[0, len) = the block's outputs in the padded layout of `src`, with
// 16-byte stores: dst is 16-byte aligned (a tile of an aligned output).
__device__ __forceinline__ void store_tile(int64_t* __restrict__ dst, int len,
                                           const int64_t* src) {
    const int t = threadIdx.x;
    longlong2* v = reinterpret_cast<longlong2*>(dst);
    for (int q = t; q < len / 2; q += kMergeThreads)
        v[q] = make_longlong2(src[padded(2 * q)], src[padded(2 * q + 1)]);
    if ((len & 1) && t == 0) dst[len - 1] = src[padded(len - 1)];
}

// Outputs of the kernels are written with 16-byte stores.
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// A tile's rows: `len` outputs of its pair, merged from the pair's A rows
// [a0, a1) and B rows [b0, b1).
struct TileRange {
    int64_t a0, a1, b0, b1;
    int len;
};

// Shared-memory words of one plane of a tile of `tile` outputs (see
// kMergePlane).
__host__ __device__ constexpr int merge_plane(int tile) { return tile + tile / kMergeItems; }

// (2a) a block of kThreads threads merges tile g of kThreads * kMergeItems
// outputs: it leaves its outputs in the padded layout of `keys` and `vals`
// (shared memory of merge_plane(tile) words each; `vals` unused without a
// payload) and each thread's own kMergeItems outputs, from position
// threadIdx.x * kMergeItems on, in k_out and v_out.
template <bool kPayload, int kThreads = kMergeThreads>
__device__ __forceinline__ TileRange merge_tile_to_shared(const MergeSpec& s, int64_t g,
                                                          const int64_t* __restrict__ corank,
                                                          int64_t* keys, int64_t* vals,
                                                          int64_t (&k_out)[kMergeItems],
                                                          int64_t (&v_out)[kPayload ? kMergeItems : 1]) {
    constexpr int kTile = kThreads * kMergeItems;
    int64_t pair, d0;
    tile_origin(s, g, pair, d0, kTile);
    const int64_t pair_len = s.na + s.nb;
    const int len = static_cast<int>(imin64(kTile, s.n - g * kTile));
    const int64_t d1 = d0 + len;
    const int64_t a0 = corank[g];
    const int64_t a1 = d1 == pair_len ? s.na : corank[g + 1];
    const int64_t b0 = d0 - a0, b1 = d1 - a1;
    const int la = static_cast<int>(a1 - a0), lb = static_cast<int>(b1 - b0);
    const int64_t off_a = pair * s.stride + a0, off_b = pair * s.stride + b0;
    // A then B, each at the word that lets it copy in 16-byte pieces: at most
    // kTile + 2 words of a plane
    int64_t* sa = congruent(keys, s.a + off_a);
    int64_t* sb = congruent(sa + la, s.b + off_b);
    stage_range<kThreads>(s.a + off_a, la, sa);
    stage_range<kThreads>(s.b + off_b, lb, sb);
    int64_t* va = nullptr;
    int64_t* vb = nullptr;
    if constexpr (kPayload) {
        va = congruent(vals, s.ca + off_a);
        vb = congruent(va + la, s.cb + off_b);
        stage_range<kThreads>(s.ca + off_a, la, va);
        stage_range<kThreads>(s.cb + off_b, lb, vb);
    }
    cp_async_wait_all();
    __syncthreads();

    const int local = threadIdx.x * kMergeItems;
    if (local < len) {
        int i = co_rank<int>(sa, la, sb, lb, local);
        int j = local - i;
#pragma unroll
        for (int k = 0; k < kMergeItems; ++k) {
            if (local + k < len) {
                const bool take_a = j >= lb || (i < la && sa[i] <= sb[j]);
                if (take_a) {
                    k_out[k] = sa[i];
                    if constexpr (kPayload) v_out[k] = va[i];
                    ++i;
                } else {
                    k_out[k] = sb[j];
                    if constexpr (kPayload) v_out[k] = vb[j];
                    ++j;
                }
            }
        }
    }
    __syncthreads();  // every read of the staged ranges is done
    if (local < len) {
#pragma unroll
        for (int k = 0; k < kMergeItems; ++k) {
            if (local + k < len) {
                keys[padded(local + k)] = k_out[k];
                if constexpr (kPayload) vals[padded(local + k)] = v_out[k];
            }
        }
    }
    __syncthreads();
    return TileRange{a0, a1, b0, b1, len};
}

// (2) the block merges tile blockIdx.x and writes it out.  `keys` and `vals`
// are shared memory of kMergePlane words each (`vals` unused without a
// payload).
template <bool kPayload>
__device__ __forceinline__ void merge_tile(const MergeSpec& s,
                                           const int64_t* __restrict__ corank,
                                           int64_t* keys, int64_t* vals) {
    const int64_t g = blockIdx.x;
    int64_t k_out[kMergeItems];
    int64_t v_out[kPayload ? kMergeItems : 1];
    const TileRange r = merge_tile_to_shared<kPayload>(s, g, corank, keys, vals, k_out, v_out);
    const int64_t o0 = g * kMergeTile;
    store_tile(s.out + o0, r.len, keys);
    if constexpr (kPayload) store_tile(s.out_c + o0, r.len, vals);
}

inline int64_t merge_tiles(int64_t n) { return (n + kMergeTile - 1) / kMergeTile; }

inline size_t merge_smem(bool payload) {
    return static_cast<size_t>(payload ? 2 : 1) * kMergePlane * sizeof(int64_t);
}

// ---------------------------------------------------------------------------
// The word merge (K9's word instance): the same two launches over tables of
// W word planes and a count plane.  Rows compare lexicographically, word 0
// first, as signed int64 (so the sentinel row sorts last); A's row comes
// first on equal rows.  Each input's word planes are `stride` elements apart
// (a table cut to its live rows keeps its uncut plane stride); its rows are
// dense in every plane.  The output's planes are n = na + nb apart.
//
// A block owns word_tile(W) outputs and stages W + 1 planes of its A and B
// ranges, so the tile shrinks as W grows: word_items(W) = 8 outputs a
// thread up to W = 3 (W = 2: 55 KB of shared memory a block, three blocks
// an SM), 4 beyond.  A thread keeps the current row of each side in registers and
// loads one row a step, then holds its outputs (W + 1 planes) in registers
// until every staged range is read.

struct WordMergeSpec {
    const int64_t* a;   // A's word 0; word w at a + w * a_stride
    const int64_t* b;
    const int64_t* ca;  // counts, dense
    const int64_t* cb;
    int64_t a_stride, b_stride;
    int64_t na, nb;
    int64_t* out;       // (W, na + nb), planes na + nb apart
    int64_t* out_c;
};

__host__ __device__ constexpr int word_items(int words) { return words <= 3 ? 8 : 4; }
__host__ __device__ constexpr int word_tile(int words) { return kMergeThreads * word_items(words); }
// shared-memory words of one plane: one pad word a thread's outputs
__host__ __device__ constexpr int word_plane(int words) { return word_tile(words) + kMergeThreads; }

inline int64_t word_merge_tiles(int words, int64_t n) {
    return (n + word_tile(words) - 1) / word_tile(words);
}

inline size_t word_merge_smem(int words) {
    return static_cast<size_t>(words + 1) * word_plane(words) * sizeof(int64_t);
}

// The least i in [max(0, d - nb), min(d, na)] with not a_le_b(i, d - i - 1):
// co_rank with the comparison a functor.
template <typename I, typename LessEq>
__device__ __forceinline__ I co_rank_by(I na, I nb, I d, LessEq a_le_b) {
    I lo = d > nb ? d - nb : 0;
    I hi = d < na ? d : na;
    while (lo < hi) {
        const I mid = lo + (hi - lo) / 2;
        if (a_le_b(mid, d - mid - 1)) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// Row i of planes x <= row j of planes y, lexicographically over W words.
template <int W, typename Px, typename Py, typename I>
__device__ __forceinline__ bool planes_le(Px x, I i, Py y, I j) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
        const int64_t u = x(w)[i], v = y(w)[j];
        if (u != v) return u < v;
    }
    return true;
}

template <int W>
__device__ __forceinline__ bool row_le(const int64_t (&x)[W + 1], const int64_t (&y)[W + 1]) {
    bool lt = false, eq = true;
#pragma unroll
    for (int w = 0; w < W; ++w) {
        lt = lt || (eq && x[w] < y[w]);
        eq = eq && x[w] == y[w];
    }
    return lt || eq;
}

// (1) corank[g] = co-rank of tile g's first output
template <int W>
__device__ __forceinline__ void word_merge_partition(const WordMergeSpec& s, int64_t tiles,
                                                     int64_t* __restrict__ corank) {
    const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (g >= tiles) return;
    auto pa = [&](int w) { return s.a + w * s.a_stride; };
    auto pb = [&](int w) { return s.b + w * s.b_stride; };
    corank[g] = co_rank_by<int64_t>(s.na, s.nb, g * word_tile(W), [&](int64_t i, int64_t j) {
        return planes_le<W>(pa, i, pb, j);
    });
}

// dst[0, len) = the outputs in the padded layout of `src` (one pad word
// every kItems), with 16-byte stores from dst's first 16-byte boundary on,
// by a block of kThreads threads.
template <int kItems, int kThreads = kMergeThreads>
__device__ __forceinline__ void store_range(int64_t* __restrict__ dst, int len,
                                            const int64_t* src) {
    const int t = threadIdx.x;
    auto at = [&](int i) { return src[i + i / kItems]; };
    const int head = (reinterpret_cast<uintptr_t>(dst) & 15) && len > 0 ? 1 : 0;
    if (head && t == 0) dst[0] = at(0);
    longlong2* v = reinterpret_cast<longlong2*>(dst + head);
    const int pairs = (len - head) >> 1;
    for (int q = t; q < pairs; q += kThreads)
        v[q] = make_longlong2(at(head + 2 * q), at(head + 2 * q + 1));
    if (((len - head) & 1) && t == 0) dst[len - 1] = at(len - 1);
}

// (2) the block merges tile blockIdx.x; smem holds W + 1 planes of
// word_plane(W) words.
template <int W>
__device__ __forceinline__ void word_merge_tile(const WordMergeSpec& s,
                                                const int64_t* __restrict__ corank,
                                                int64_t* smem) {
    constexpr int kItems = word_items(W);
    constexpr int kTile = word_tile(W);
    constexpr int kPlane = word_plane(W);
    const int64_t n = s.na + s.nb;
    const int64_t g = blockIdx.x;
    const int64_t d0 = g * kTile;
    const int len = static_cast<int>(imin64(kTile, n - d0));
    const int64_t d1 = d0 + len;
    const int64_t a0 = corank[g];
    const int64_t a1 = d1 == n ? s.na : corank[g + 1];
    const int64_t b0 = d0 - a0;
    const int la = static_cast<int>(a1 - a0), lb = static_cast<int>(d1 - a1 - b0);
    // plane w's A range, then its B range, each at the word that lets it copy
    // in 16-byte pieces (the count plane is plane W)
    int64_t* sa[W + 1];
    int64_t* sb[W + 1];
#pragma unroll
    for (int w = 0; w <= W; ++w) {
        const int64_t* src_a = w < W ? s.a + w * s.a_stride + a0 : s.ca + a0;
        const int64_t* src_b = w < W ? s.b + w * s.b_stride + b0 : s.cb + b0;
        sa[w] = congruent(smem + w * kPlane, src_a);
        sb[w] = congruent(sa[w] + la, src_b);
        stage_range(src_a, la, sa[w]);
        stage_range(src_b, lb, sb[w]);
    }
    cp_async_wait_all();
    __syncthreads();

    const int local = threadIdx.x * kItems;
    int64_t out[W + 1][kItems];
    if (local < len) {
        int i = co_rank_by<int>(la, lb, local, [&](int x, int y) {
            return planes_le<W>([&](int w) { return sa[w]; }, x, [&](int w) { return sb[w]; }, y);
        });
        int j = local - i;
        int64_t ra[W + 1], rb[W + 1];
#pragma unroll
        for (int w = 0; w <= W; ++w) {
            ra[w] = i < la ? sa[w][i] : 0;
            rb[w] = j < lb ? sb[w][j] : 0;
        }
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
            if (local + k < len) {
                const bool take_a = j >= lb || (i < la && row_le<W>(ra, rb));
#pragma unroll
                for (int w = 0; w <= W; ++w) out[w][k] = take_a ? ra[w] : rb[w];
                if (take_a) {
                    ++i;
                    if (i < la) {
#pragma unroll
                        for (int w = 0; w <= W; ++w) ra[w] = sa[w][i];
                    }
                } else {
                    ++j;
                    if (j < lb) {
#pragma unroll
                        for (int w = 0; w <= W; ++w) rb[w] = sb[w][j];
                    }
                }
            }
        }
    }
    __syncthreads();  // every read of the staged ranges is done
    if (local < len) {
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
            if (local + k < len) {
                const int slot = local + k + (local + k) / kItems;
#pragma unroll
                for (int w = 0; w <= W; ++w) smem[w * kPlane + slot] = out[w][k];
            }
        }
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < W; ++w) store_range<kItems>(s.out + w * n + d0, len, smem + w * kPlane);
    store_range<kItems>(s.out_c + d0, len, smem + W * kPlane);
}

}  // namespace kmers
