// K11: bitonic sort of int64 keys (the port's key format, signed ascending).
//
// Replaces the TPU kernels kmers_tpu/ops/pallas/sort_kernel.py
// bitonic_local_sort_pallas (the local pass) and bitonic_sort_pallas (the
// cross-tile stages and their fused in-tile tails).  The network is the
// textbook one: stage k = 1 .. log2(n) runs the compare-exchange steps of
// strides 2^(k-1) .. 1 on the pairs (i, i + d) with i's bit j clear, and
// orders each pair descending where bit k of i is set ((pos >> k) & 1, the
// direction rule of the TPU kernel), so after stage k every run of 2^k keys
// is sorted, alternately ascending and descending, and after the last stage
// the whole array is ascending.
//
// What bounds it on an H100: a sort reads and writes each 8-byte key at
// least once (16 bytes a key), and that is the bound the port reports; the
// network itself moves the keys through device memory once for the local
// pass, once for every cross-tile step and once for every tail, so at
// n = 2^24 with a tile of 2^13 it makes 78 round trips (1 local, 66
// cross-tile, 11 tails) where the bound counts one.  It is a simple, correct first kernel,
// slower than torch.sort by design; register-level sub-sorts, warp shuffles
// for small strides and a merge-based cross-tile step are later work.
//
// Design, and where the TPU design does not carry over:
// - Local pass (bitonic_tile_kernel over stages 1 .. log2(tile)): one block
//   sorts one tile in dynamic shared memory; each thread runs the pairs
//   p = t, t + blockDim, ... of a step, with a barrier between steps.  The
//   direction comes from the key's global position, so consecutive tiles
//   come out ascending, descending, ascending, ... as on the TPU.
// - Cross-tile strides (d >= tile): bitonic_pass_kernel, one thread per
//   pair in device memory.
// - Tail of a cross-tile stage k (strides tile/2 .. 1): the tile kernel
//   again, for that one stage, in place.
// - The TPU's tile is 8 x 4096 = 32,768 u32 pairs (256 KB as int64), more
//   than an H100 block can address (227 KB of dynamic shared memory after
//   cudaFuncSetAttribute, 48 KB without).  The tile is a runtime argument
//   (a power of two, at most kMaxTile = 16,384 keys = 128 KB); the port's
//   default is 8,192 keys (64 KB, so three blocks fit on one SM's 228 KB),
//   in ops/kernels/sort_kernel.py.
// - Indices are int64 and the direction bit is taken from a 64-bit
//   position, so 2^26 keys and more are addressed without overflow.
// - Equal keys are exchanged or not with the same result: a sort of keys
//   alone has no ties to break.
#include "common.cuh"

namespace {

constexpr int kMaxTile = 16384;     // keys a block holds: 128 KB of shared memory
constexpr int kTileThreads = 512;
constexpr int kPairThreads = 256;

// a at the lower position: ascending leaves the smaller key there
__device__ __forceinline__ void compare_exchange(int64_t& a, int64_t& b, bool desc) {
    if (desc ? a < b : b < a) {
        const int64_t t = a;
        a = b;
        b = t;
    }
}

// Stages k_first .. k_last of the network on the block's tile of `tile`
// keys: stage k runs the strides 2^(min(k, log_tile) - 1) .. 1.  `in` and
// `out` may be the same array (a block reads its whole tile first).
__global__ void __launch_bounds__(kTileThreads)
bitonic_tile_kernel(const int64_t* in, int64_t* out, int tile, int log_tile,
                    int k_first, int k_last) {
    extern __shared__ int64_t s[];
    const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = in[base + i];
    __syncthreads();
    const int half = tile >> 1;
    for (int k = k_first; k <= k_last; ++k) {
        const int top = (k < log_tile ? k : log_tile) - 1;
        for (int j = top; j >= 0; --j) {
            const int d = 1 << j;
            for (int p = threadIdx.x; p < half; p += blockDim.x) {
                const int i = ((p >> j) << (j + 1)) | (p & (d - 1));
                compare_exchange(s[i], s[i + d], ((base + i) >> k) & 1);
            }
            __syncthreads();
        }
    }
    for (int i = threadIdx.x; i < tile; i += blockDim.x) out[base + i] = s[i];
}

// One compare-exchange step of stride 2^j in stage k over device memory.
__global__ void __launch_bounds__(kPairThreads)
bitonic_pass_kernel(int64_t* __restrict__ keys, int64_t pairs, int j, int k) {
    const int64_t p = static_cast<int64_t>(blockIdx.x) * kPairThreads + threadIdx.x;
    if (p >= pairs) return;
    const int64_t d = static_cast<int64_t>(1) << j;
    const int64_t i = ((p >> j) << (j + 1)) | (p & (d - 1));
    int64_t a = keys[i], b = keys[i + d];
    compare_exchange(a, b, (i >> k) & 1);
    keys[i] = a;
    keys[i + d] = b;
}

int log2_of(long long v) {
    int m = 0;
    while ((1ll << m) < v) ++m;
    return m;
}

bool valid_tile(long long n, int tile) {
    return tile >= 1 && tile <= kMaxTile && (tile & (tile - 1)) == 0 && n % tile == 0;
}

cudaError_t launch_tiles(const int64_t* in, int64_t* out, long long n, int tile,
                         int k_first, int k_last, cudaStream_t stream) {
    const size_t smem = static_cast<size_t>(tile) * sizeof(int64_t);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            bitonic_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    const int threads = tile / 2 < 1 ? 1 : (tile / 2 < kTileThreads ? tile / 2 : kTileThreads);
    bitonic_tile_kernel<<<static_cast<unsigned>(n / tile), threads, smem, stream>>>(
        in, out, tile, log2_of(tile), k_first, k_last);
    return cudaGetLastError();
}

}  // namespace

// The largest tile the kernel takes (keys held in one block's shared memory).
extern "C" int k11_max_tile() { return kMaxTile; }

// out: int64[n], every tile of `in` sorted, the tile at position t * tile
// ascending for even t and descending for odd t.  tile a power of two, at
// most k11_max_tile(), dividing n.
extern "C" int k11_bitonic_local(const void* in, void* out, long long n, int tile,
                                 void* stream) {
    if (!valid_tile(n, tile)) return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return static_cast<int>(cudaGetLastError());
    return static_cast<int>(launch_tiles(static_cast<const int64_t*>(in),
                                         static_cast<int64_t*>(out), n, tile, 1,
                                         log2_of(tile), static_cast<cudaStream_t>(stream)));
}

// The stages above the tile, in place, on keys that went through
// k11_bitonic_local with the same tile: keys ascending on return.  n a power
// of two.
extern "C" int k11_bitonic_merge(void* keys_, long long n, int tile, void* stream) {
    if (!valid_tile(n, tile) || (n & (n - 1)) != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    auto* keys = static_cast<int64_t*>(keys_);
    const auto s = static_cast<cudaStream_t>(stream);
    const int log_tile = log2_of(tile);
    const int log_n = log2_of(n);
    const long long pairs = n / 2;
    const long long blocks = (pairs + kPairThreads - 1) / kPairThreads;
    for (int k = log_tile + 1; k <= log_n; ++k) {
        for (int j = k - 1; j >= log_tile; --j) {
            bitonic_pass_kernel<<<static_cast<unsigned>(blocks), kPairThreads, 0, s>>>(
                keys, pairs, j, k);
            const cudaError_t err = cudaGetLastError();
            if (err != cudaSuccess) return static_cast<int>(err);
        }
        const cudaError_t err = launch_tiles(keys, keys, n, tile, k, k, s);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaGetLastError());
}
