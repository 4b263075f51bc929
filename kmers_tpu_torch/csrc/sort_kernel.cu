// K11: sort of int64 keys (the port's key format, signed ascending): the
// bitonic local pass, and the full sort as that pass followed by merge-path
// rounds.
//
// Replaces the TPU kernels kmers_tpu/ops/pallas/sort_kernel.py
// bitonic_local_sort_pallas (every tile sorted, the direction following the
// network's rule (pos >> k) & 1 of the global position, so consecutive tiles
// come out ascending, descending, ...) and bitonic_sort_pallas (the full
// ascending sort).
//
// What bounds it on an H100: a sort reads and writes each 8-byte key at
// least once (16 bytes a key over 3.35 TB/s), and that is the bound the port
// reports.  A bitonic network's cross-tile steps each move every key through
// device memory (78 passes at n = 2^24 with a tile of 8,192), and a tile's
// 91 compare-exchange steps in shared memory need a barrier each.  So the
// network stays inside the block, mostly in registers, and merges take the
// place of the cross-tile stages:
//
// - k11_tile_kernel<kR> sorts a block of kSortThreads * kR keys in
//   registers: each thread holds kR consecutive keys, loaded and stored
//   through shared memory with 16-byte device-memory accesses.  Strides
//   below kR run inside the thread with no barrier; strides kR .. 16 kR run
//   across the warp by __shfl_xor_sync; only strides of 32 kR and above go
//   through shared memory, each step with one barrier (10 of the 91 steps
//   for a tile of 8,192 keys at kR = 16).  Shared memory is
//   XOR-swizzled so that a warp's kR-strided register stores and loads fall
//   on distinct banks.  kR = 16 (512 threads, 64 KB, two blocks an SM) takes
//   tiles up to 8,192 keys; kR = 32 (128 KB) the largest tile, 16,384.  The
//   local pass runs the network's stages 1 .. log2(tile) with the TPU's
//   direction rule; the full sort runs them with the last stage ascending
//   in every tile, so that its runs are all ascending.
// - k11_merge_rounds: log2(n / tile) rounds, each merging neighbouring
//   sorted runs pairwise by the merge path of merge_path.cuh (no payload),
//   from one buffer into the other: each round reads and writes every key
//   once, coalesced, with one partition launch (a co-rank a tile of 4,096
//   outputs) and one merge launch.  At n = 2^24 that is 12 passes over the
//   keys: the tile sort and 11 rounds.
//
// Indices are int64, so 2^26 keys and more are addressed without overflow.
// Equal keys are exchanged or not with the same result: a sort of keys
// alone has no ties to break.
#include "common.cuh"
#include "merge_path.cuh"

namespace {

constexpr int kSortThreads = 512;
constexpr int kWarpLanes = 32;

// a at the lower position: ascending leaves the smaller key there
__device__ __forceinline__ void compare_exchange(int64_t& a, int64_t& b, bool desc) {
    const bool swap = (b < a) != desc;
    const int64_t x = a;
    a = swap ? b : a;
    b = swap ? x : b;
}

// Shared-memory word of position p of the block: the low four bits XOR the
// low four bits of the position's thread, so that for a fixed register r
// the positions t kR + r of 16 consecutive threads fall on 16 distinct
// 8-byte banks.  The swizzle stays inside a thread's kR positions.
template <int kLogR>
__device__ __forceinline__ int swz(int p) {
    return p ^ ((p >> kLogR) & 15);
}

// Every tile of 2^log_tile keys of in[block's range] sorted into out by the
// network's stages 1 .. log_tile.  Positions at or past n (the last block's
// tail) hold padding that never meets a real key: the network's pairs stay
// inside one tile, and the tile divides n.
template <int kR>
__global__ void __launch_bounds__(kSortThreads, kR <= 16 ? 2 : 1)
k11_tile_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out, int64_t n,
                int log_tile, bool all_asc) {
    constexpr int kLogR = kR == 16 ? 4 : 5;
    static_assert((1 << kLogR) == kR, "kR is 16 or 32");
    constexpr int kCap = kSortThreads * kR;
    constexpr int kLogWarp = kLogR + 5;  // strides below 2^kLogWarp stay in the warp
    constexpr int kLogCap = kLogWarp + 4;  // 16 warps
    static_assert((1 << kLogCap) == kCap, "512 threads");
    extern __shared__ int64_t s[];
    const int t = threadIdx.x;
    const int lane = t & (kWarpLanes - 1);
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kCap;
    const int len = static_cast<int>(n - base < kCap ? n - base : kCap);

    // load: 16-byte reads of device memory where `in` allows, into the
    // swizzled layout
    const int64_t* src = in + base;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const longlong2* v = reinterpret_cast<const longlong2*>(src);
#pragma unroll 4
        for (int q = t; q < kCap / 2; q += kSortThreads) {
            longlong2 x = make_longlong2(KMERS_SENTINEL, KMERS_SENTINEL);
            if (2 * q + 1 < len) x = v[q];
            else if (2 * q < len) x.x = src[2 * q];
            s[swz<kLogR>(2 * q)] = x.x;
            s[swz<kLogR>(2 * q + 1)] = x.y;
        }
    } else {
        for (int i = t; i < kCap; i += kSortThreads)
            s[swz<kLogR>(i)] = i < len ? src[i] : KMERS_SENTINEL;
    }
    __syncthreads();
    int64_t v[kR];
    const int first = t * kR;  // the thread's positions first .. first + kR - 1
#pragma unroll
    for (int r = 0; r < kR; ++r) v[r] = s[swz<kLogR>(first + r)];

    // Stage k orders a pair descending where bit k of its global position is
    // set (the TPU's rule), except in the last stage under all_asc.  Bit k of
    // base + p is bit k of p below kLogCap, and a bit of the block index above.
    const unsigned block = blockIdx.x;
    auto bit = [block](unsigned p, int k) -> bool {
        return k < kLogCap ? (p >> k) & 1u : (block >> (k - kLogCap)) & 1u;
    };
    // stages 1 .. kLogR - 1 hold only strides below kR, inside the thread;
    // the direction of register r is bit k of r (first is a multiple of kR),
    // known at compile time
#pragma unroll
    for (int k = 1; k < kLogR; ++k) {
        if (k <= log_tile) {
            const bool asc = all_asc && k == log_tile;
#pragma unroll
            for (int j = k - 1; j >= 0; --j) {
#pragma unroll
                for (int r = 0; r < kR; ++r)
                    if ((r & (1 << j)) == 0)
                        compare_exchange(v[r], v[r | (1 << j)], !asc && ((r >> k) & 1));
            }
        }
    }
    for (int k = kLogR; k <= log_tile; ++k) {
        const bool asc = all_asc && k == log_tile;
        const int top = k - 1;  // stage k's strides are 2^top .. 1
        if (top >= kLogWarp) {
            // strides of 32 kR and up: one thread a pair in shared memory
#pragma unroll
            for (int r = 0; r < kR; ++r) s[swz<kLogR>(first + r)] = v[r];
            __syncthreads();
            for (int j = top; j >= kLogWarp; --j) {
                const int d = 1 << j;
#pragma unroll
                for (int q = t; q < kCap / 2; q += kSortThreads) {
                    const int lo = ((q >> j) << (j + 1)) | (q & (d - 1));
                    const int a = swz<kLogR>(lo), b = swz<kLogR>(lo + d);
                    int64_t x = s[a], y = s[b];
                    compare_exchange(x, y, !asc && bit(lo, k));
                    s[a] = x;
                    s[b] = y;
                }
                __syncthreads();
            }
#pragma unroll
            for (int r = 0; r < kR; ++r) v[r] = s[swz<kLogR>(first + r)];
        }
        // from here on bit k is the same for all of the thread's positions
        const bool desc = !asc && bit(first, k);
        // strides kR .. 16 kR: the partner is lane ^ (d / kR), same register
#pragma unroll
        for (int j = kLogWarp - 1; j >= kLogR; --j) {
            if (j <= top) {
                const int m = 1 << (j - kLogR);
                const bool keep_max = ((lane & m) == 0) == desc;
#pragma unroll
                for (int r = 0; r < kR; ++r) {
                    const int64_t other = static_cast<int64_t>(__shfl_xor_sync(
                        0xFFFFFFFFu, static_cast<long long>(v[r]), m));
                    v[r] = (other < v[r]) != keep_max ? other : v[r];
                }
            }
        }
        // strides below kR: inside the thread
#pragma unroll
        for (int j = kLogR - 1; j >= 0; --j) {
            if (j <= top) {
#pragma unroll
                for (int r = 0; r < kR; ++r)
                    if ((r & (1 << j)) == 0) compare_exchange(v[r], v[r | (1 << j)], desc);
            }
        }
    }

    // store: through the swizzled layout, 16-byte writes (out is aligned)
#pragma unroll
    for (int r = 0; r < kR; ++r) s[swz<kLogR>(first + r)] = v[r];
    __syncthreads();
    int64_t* dst = out + base;
    longlong2* w = reinterpret_cast<longlong2*>(dst);
    for (int q = t; q < kCap / 2; q += kSortThreads) {
        if (2 * q + 1 < len) w[q] = make_longlong2(s[swz<kLogR>(2 * q)], s[swz<kLogR>(2 * q + 1)]);
        else if (2 * q < len) dst[2 * q] = s[swz<kLogR>(2 * q)];
    }
}

__global__ void __launch_bounds__(kmers::kMergeThreads)
k11_partition_kernel(kmers::MergeSpec s, int64_t tiles, int64_t* __restrict__ corank) {
    kmers::merge_partition(s, tiles, corank);
}

__global__ void __launch_bounds__(kmers::kMergeThreads, 4)
k11_round_kernel(kmers::MergeSpec s, const int64_t* __restrict__ corank) {
    extern __shared__ int64_t smem[];
    kmers::merge_tile<false>(s, corank, smem, nullptr);
}

constexpr int kMaxTile = kSortThreads * 32;  // 16,384 keys: 128 KB of shared memory

int log2_of(long long v) {
    int m = 0;
    while ((1ll << m) < v) ++m;
    return m;
}

bool valid_tile(long long n, int tile) {
    return n >= 0 && tile >= 1 && tile <= kMaxTile && (tile & (tile - 1)) == 0 &&
           n % tile == 0;
}

template <int kR>
cudaError_t launch_tiles(const int64_t* in, int64_t* out, long long n, int tile,
                         bool all_asc, cudaStream_t stream) {
    constexpr int kCap = kSortThreads * kR;
    const size_t smem = static_cast<size_t>(kCap) * sizeof(int64_t);
    const cudaError_t err = cudaFuncSetAttribute(
        k11_tile_kernel<kR>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const long long blocks = (n + kCap - 1) / kCap;
    k11_tile_kernel<kR><<<static_cast<unsigned>(blocks), kSortThreads, smem, stream>>>(
        in, out, n, log2_of(tile), all_asc);
    return cudaGetLastError();
}

}  // namespace

// The largest tile the kernel takes (keys held in one block).
extern "C" int k11_max_tile() { return kMaxTile; }

// out: int64[n], 16-byte aligned, every tile of `in` sorted: with all_asc 0,
// the tile at position t * tile ascending for even t and descending for odd
// t (the local pass); with all_asc 1, every tile ascending (the full sort's
// first step).  tile a power of two, at most k11_max_tile(), dividing n.
extern "C" int k11_tile_sort(const void* in, void* out, long long n, int tile, int all_asc,
                             void* stream) {
    if (!valid_tile(n, tile) || !kmers::aligned16(out))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return static_cast<int>(cudaGetLastError());
    const auto* src = static_cast<const int64_t*>(in);
    auto* dst = static_cast<int64_t*>(out);
    const auto st = static_cast<cudaStream_t>(stream);
    const cudaError_t err = tile <= kSortThreads * 16
        ? launch_tiles<16>(src, dst, n, tile, all_asc != 0, st)
        : launch_tiles<32>(src, dst, n, tile, all_asc != 0, st);
    return static_cast<int>(err);
}

// `rounds` merge rounds over n keys that lie in buf0 (buf0 and buf1 16-byte
// aligned) as ascending runs of
// `run` keys: round r merges runs of run << r pairwise from one buffer into
// the other (buf0 -> buf1 -> buf0 ...), so the keys end ascending in
// runs of run << rounds, in buf1 when rounds is odd and in buf0 when it is
// even.  scratch: int64[tiles], tiles = n / k9_merge_tile().  n and run are
// powers of two, 2 run a multiple of k9_merge_tile(), run << rounds at most n.
extern "C" int k11_merge_rounds(void* buf0, void* buf1, long long n, long long run, int rounds,
                                void* scratch, long long tiles, void* stream) {
    if (rounds < 0 || rounds > 40 || run <= 0 || (run & (run - 1)) != 0 || n <= 0 ||
        (n & (n - 1)) != 0 || n % (2 * run) != 0 ||
        (2 * run) % kmers::kMergeTile != 0 || (run << rounds) > n ||
        tiles != kmers::merge_tiles(n) || !kmers::aligned16(buf0) || !kmers::aligned16(buf1))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto st = static_cast<cudaStream_t>(stream);
    const size_t smem = kmers::merge_smem(false);
    auto* corank = static_cast<int64_t*>(scratch);
    int64_t* bufs[2] = {static_cast<int64_t*>(buf0), static_cast<int64_t*>(buf1)};
    const long long part_blocks = (tiles + kmers::kMergeThreads - 1) / kmers::kMergeThreads;
    for (int r = 0; r < rounds; ++r, run *= 2) {
        const int64_t* src = bufs[r & 1];
        kmers::MergeSpec s{src, src + run, nullptr, nullptr, run, run, 2 * run, n,
                           bufs[(r + 1) & 1], nullptr};
        k11_partition_kernel<<<static_cast<unsigned>(part_blocks), kmers::kMergeThreads, 0, st>>>(
            s, tiles, corank);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        k11_round_kernel<<<static_cast<unsigned>(tiles), kmers::kMergeThreads, smem, st>>>(
            s, corank);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaGetLastError());
}
