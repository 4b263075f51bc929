// K2: unit-weight run-length encoding of a sorted int64 key stream, with the
// JAX package's sentinel-interspersed contract: the last slot of each run
// keeps its key and the run's length, every other slot (and the whole run of
// INT64_MAX sentinels) holds INT64_MAX and count 0; n_unique counts the
// emitted runs.
//
// Replaces the TPU kernel kmers_tpu/ops/pallas/rle_kernel.py rle_unit_pallas
// (_kernel).
//
// What bounds it on an H100: per element it reads one 8-byte key (and its
// neighbour, from cache) and writes 16 bytes, so it is memory-bound; the
// run-start search adds reads only at each run's last element.
//
// Design: the TPU kernel walked the stream in order and carried the last key
// and the run start from one grid step to the next.  CUDA blocks run in no
// order, and one run can span many blocks (poly-A and tandem repeats put
// 10^4-10^5 copies of one key in a chunk), so nothing is carried: on a
// sorted stream a run that ends at i has length i - start + 1, where start
// is the first index holding keys[i].  The last element of each run finds
// start by a galloping search backwards from i (doubling steps, then
// bisection), which costs O(log run length) reads, mostly from L1/L2.
// n_unique is a block count (__syncthreads_count) added atomically.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;

// first index of the run that holds keys[i] (keys sorted ascending)
__device__ __forceinline__ int64_t run_start(const int64_t* __restrict__ keys,
                                             int64_t i, int64_t key) {
    // invariant: keys[hi] == key; lo < 0 or keys[lo] < key
    int64_t hi = i, lo = i - 1, step = 1;
    while (lo >= 0 && keys[lo] == key) {
        hi = lo;
        step <<= 1;
        lo = i - step;
    }
    if (lo < -1) lo = -1;
    while (hi - lo > 1) {
        const int64_t mid = lo + (hi - lo) / 2;
        if (keys[mid] == key) hi = mid; else lo = mid;
    }
    return hi;
}

__global__ void __launch_bounds__(kBlock)
rle_unit_kernel(const int64_t* __restrict__ keys, int64_t n,
                int64_t* __restrict__ uniq, int64_t* __restrict__ counts,
                unsigned long long* __restrict__ n_unique) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
    bool emit = false;
    if (i < n) {
        const int64_t key = keys[i];
        const bool last = i == n - 1 || keys[i + 1] != key;
        emit = last && key != KMERS_SENTINEL;
        uniq[i] = emit ? key : KMERS_SENTINEL;
        counts[i] = emit ? i - run_start(keys, i, key) + 1 : 0;
    }
    const int block_unique = __syncthreads_count(emit);
    if (threadIdx.x == 0 && block_unique)
        atomicAdd(n_unique, static_cast<unsigned long long>(block_unique));
}

}  // namespace

// uniq, counts: int64[n]; n_unique: int64[1] zeroed by the caller.
extern "C" int k2_rle_unit(const void* keys, long long n, void* uniq,
                           void* counts, void* n_unique, void* stream) {
    if (n > 0) {
        const long long blocks = (n + kBlock - 1) / kBlock;
        rle_unit_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int64_t*>(keys), n, static_cast<int64_t*>(uniq),
            static_cast<int64_t*>(counts),
            static_cast<unsigned long long*>(n_unique));
    }
    return static_cast<int>(cudaGetLastError());
}
