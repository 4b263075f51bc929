// K12: the minimizer selection of one chunk of a walk, over K6's registers.
// Per window of W consecutive registers it takes the FxHash order key of
// each (the unsigned reg * FX mod 2^64), the leftmost minimum, drops the
// window whose pick repeats the previous window's, and front-packs the kept
// (value, position) rows in window order.  In skipping mode a register equal
// to the sentinel (a window over an uncertain base) is no candidate, keyed
// as all ones, and a window whose minimum is that key selects nothing.  The
// chunk's first window is compared with the previous chunk's last pick
// (prev_in), and the chunk's last pick is written for the next (prev_out;
// -1: none); positions are shifted by the chunk's first window.
//
// It replaces no TPU kernel: the JAX package selects minimizers in plain jnp
// (kmers_tpu/ops/minimizer.py, a doubling sliding minimum).  On the card the
// port's plain route (ops/minimizer.py's doubling minimum over (key,
// position, k-mer), then the dedup, torch.nonzero and two gathers) ran ~40
// device passes a chunk and wrote four 24-byte rows a window at W = 10.
//
// What bounds it on an H100: it reads each 8-byte register once (and W - 1
// more a tile of 2,048 windows) and writes 16 bytes a kept row, ~0.18 rows a
// window at (K, W) = (15, 10) on a chromosome, so device memory: ~11 bytes a
// window over 3.35 TB/s.  Its design, a block of 256 threads a tile of
// kTileWindows = 2,048 windows:
// - Stage: the keys of registers base - 1 .. base + 2,048 + W - 2 (the
//   tile's, a W - 1 halo on the right and the one register before it) go to
//   shared memory, each thread loading every 256th, coalesced; a register
//   past the chunk's end is keyed as no candidate.  The value is not staged:
//   FX is odd, so a pick's register is its key times FX's inverse.
// - Sliding minimum (van Herk / Gil-Werman): the staged keys fall into
//   segments of W; one thread a segment scans it forward for the prefix
//   argmin (strict <: leftmost) and backward for the suffix argmin (<=:
//   leftmost), as 16-bit indices.  A window [l, l + W) is then the suffix of
//   l's segment and the prefix of the next up to l + W - 1 (when l starts a
//   segment, both are that segment), so its pick is two index reads and one
//   key comparison, ties to the suffix, the lower position: about three
//   comparisons a window at any W.  The serial scans have W steps, so at the
//   cap W = 256 nine threads of a block do them; minimap2 keeps w < 256.
// - Repeats: warp w takes windows 256 w .. 256 w + 255 of the tile in eight
//   rounds of 32; a lane's window is compared with its left neighbour's pick
//   by a shuffle, lane 0 with the last pick of the round before, and a
//   warp's first window with the pick of the window before it, recomputed
//   from the staged halo (the chunk's first window: prev_in).
// - Compaction: each round's kept windows are a ballot; the warp totals give
//   the tile's count and each warp's offset; the tile's output offset comes
//   from the decoupled look-back of lookback.cuh (tiles by ticket), so rows
//   come out in window order in one pass.  The last tile writes the chunk's
//   row count (count) for the host's one read a chunk.  Kept lanes recompute
//   their pick and write their rows (each round's rows are contiguous).
// Shared memory: 12 bytes a staged register, (2,048 + W) * 12 bytes a block:
// 24.7 KB at W = 10, 27.6 KB at the cap.
#include "common.cuh"
#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;                          // rounds of 32 windows a warp
constexpr int kWarpWindows = 32 * kRounds;
constexpr int kTileWindows = kThreads * kRounds;    // windows a block owns
constexpr int kMaxW = 256;                          // 16-bit staged indices hold the tile

constexpr uint64_t kFx = 0x517CC1B727220A95ull;

constexpr uint64_t inverse_mod_2_64(uint64_t a) {
    uint64_t x = a;  // an odd a is its own inverse mod 8; each step doubles the bits
    for (int i = 0; i < 5; ++i) x *= 2 - a * x;
    return x;
}

constexpr uint64_t kFxInverse = inverse_mod_2_64(kFx);
static_assert(kFx * kFxInverse == 1, "a register is its key times FX's inverse");

// the key of a register that is no candidate: above every FxHash of a K <= 31
// register (the all-ones hash is that of 0xDFBFFFC287F68F43 >= 2^62)
constexpr uint64_t kNone = ~0ull;

struct SelectSpec {
    const int64_t* regs;       // windows + W - 1 registers
    int64_t windows;
    int W;
    int skip;                  // nonzero: a sentinel register is no candidate
    int64_t shift;             // the output position of the chunk's register 0
    const int64_t* prev_in;    // the pick of the window before the chunk (-1: none)
    int64_t* prev_out;         // the pick of the chunk's last window (-1: none)
    int64_t* values;
    int64_t* positions;
    int64_t* count;            // the chunk's kept rows
    unsigned long long* ticket;
    unsigned long long* status;
};

// The staged index of the leftmost minimum of the window of W staged keys
// from l: the suffix of l's segment against the prefix of the next.
__device__ __forceinline__ int pick(const uint64_t* key, const uint16_t* pre,
                                    const uint16_t* suf, int l, int W) {
    const int s = suf[l], q = pre[l + W - 1];
    return key[q] < key[s] ? q : s;
}

__global__ void __launch_bounds__(kThreads)
k12_minimizer_kernel(SelectSpec s) {
    extern __shared__ uint64_t key[];   // n keys, then the prefix and suffix indices
    __shared__ int64_t s_tile;
    __shared__ int s_kept[kWarps];
    __shared__ unsigned long long s_off;
    const int W = s.W;
    const int n = kTileWindows + W;
    uint16_t* pre = reinterpret_cast<uint16_t*>(key + n);
    uint16_t* suf = pre + n;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    if (threadIdx.x == 0) s_tile = static_cast<int64_t>(atomicAdd(s.ticket, 1ull));
    __syncthreads();
    const int64_t g = s_tile;
    const int64_t base = g * kTileWindows;
    const int in_tile = static_cast<int>(s.windows - base < kTileWindows ? s.windows - base
                                                                          : kTileWindows);
    // (1) the keys of registers base - 1 .. base + kTileWindows + W - 2
    const int64_t first = base - 1;
    const int64_t n_regs = s.windows + W - 1;
    for (int l = threadIdx.x; l < n; l += kThreads) {
        const int64_t r = first + l;
        uint64_t k = kNone;
        if (r >= 0 && r < n_regs) {
            const int64_t v = __ldg(s.regs + r);
            if (!(s.skip && v == KMERS_SENTINEL)) k = static_cast<uint64_t>(v) * kFx;
        }
        key[l] = k;
    }
    __syncthreads();
    // (2) the prefix and suffix argmin of every segment of W staged keys
    for (int a = threadIdx.x * W; a < n; a += kThreads * W) {
        const int b = a + W < n ? a + W : n;
        int best = a;
        uint64_t bk = key[a];
        pre[a] = static_cast<uint16_t>(a);
        for (int l = a + 1; l < b; ++l) {
            const uint64_t k = key[l];
            if (k < bk) {
                bk = k;
                best = l;
            }
            pre[l] = static_cast<uint16_t>(best);
        }
        best = b - 1;
        bk = key[best];
        suf[best] = static_cast<uint16_t>(best);
        for (int l = b - 2; l >= a; --l) {
            const uint64_t k = key[l];
            if (k <= bk) {
                bk = k;
                best = l;
            }
            suf[l] = static_cast<uint16_t>(best);
        }
    }
    __syncthreads();
    // (3) each window's pick (tile window i is staged from i + 1), kept where
    // it has one and it differs from the window before's
    const int64_t origin = s.shift + first;   // the output position of staged register 0
    const int w0 = warp * kWarpWindows;
    int64_t last;                              // the pick of the window before (-1: none)
    if (g == 0 && warp == 0) {
        last = *s.prev_in;
    } else {
        const int p = pick(key, pre, suf, w0, W);
        last = s.skip && key[p] == kNone ? -1 : origin + p;
    }
    uint32_t kept[kRounds];
    int n_kept = 0;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
        const int i = w0 + 32 * r + lane;
        const int p = pick(key, pre, suf, i + 1, W);
        const bool has = i < in_tile && !(s.skip && key[p] == kNone);
        const int64_t mine = has ? origin + p : -1;
        int64_t before = __shfl_up_sync(0xFFFFFFFFu, mine, 1);
        if (lane == 0) before = last;
        last = __shfl_sync(0xFFFFFFFFu, mine, 31);
        kept[r] = __ballot_sync(0xFFFFFFFFu, has && mine != before);
        n_kept += __popc(kept[r]);
        if (i == in_tile - 1 && g == gridDim.x - 1) *s.prev_out = mine;
    }
    // (4) the tile's count published, its offset by the look-back
    if (lane == 0) s_kept[warp] = n_kept;
    __syncthreads();
    int rank = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        rank += w < warp ? s_kept[w] : 0;
        total += s_kept[w];
    }
    if (threadIdx.x == 0)
        kmers::publish(s.status + g, (g == 0 ? kmers::kPrefix : kmers::kAggregate) |
                                         static_cast<unsigned long long>(total));
    if (warp == 0) {
        const unsigned long long off = g == 0 ? 0ull : kmers::look_back(s.status, g);
        if (lane == 0) {
            if (g > 0) kmers::publish(s.status + g, kmers::kPrefix | (off + total));
            if (g == gridDim.x - 1) *s.count = static_cast<int64_t>(off + total);
            s_off = off;
        }
    }
    __syncthreads();
    // (5) the kept rows in window order from the tile's offset
    int64_t at = static_cast<int64_t>(s_off) + rank;
    const uint32_t below = (1u << lane) - 1;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
        if (kept[r] >> lane & 1u) {
            const int p = pick(key, pre, suf, w0 + 32 * r + lane + 1, W);
            const int64_t o = at + __popc(kept[r] & below);
            s.values[o] = static_cast<int64_t>(key[p] * kFxInverse);
            s.positions[o] = origin + p;
        }
        at += __popc(kept[r]);
    }
}

}  // namespace

// Windows a block of K12 owns (kmers_tpu_torch/ops/kernels/minimizer_kernel.py).
extern "C" int k12_tile() { return kTileWindows; }

// K12 on one chunk.  regs: int64[windows + W - 1], K6's registers;
// 1 <= W <= 256; skip: a sentinel register is no candidate; shift: the
// output position of regs[0]; prev_in, prev_out: one int64 each, distinct
// (the pick before the chunk, read; the chunk's last pick, written; -1:
// none); values, positions: int64[windows], the kept rows from the front;
// work: int64[tiles + 2], tiles = ceil(windows / k12_tile()): the kept rows'
// count (written), the ticket and the tiles' status words (cleared here).
extern "C" int k12_select_minimizers(const void* regs, long long windows, int W, int skip,
                                     long long shift, const void* prev_in, void* prev_out,
                                     void* values, void* positions, void* work,
                                     long long tiles, void* stream) {
    if (W < 1 || W > kMaxW || windows < 0 ||
        tiles != (windows + kTileWindows - 1) / kTileWindows)
        return static_cast<int>(cudaErrorInvalidValue);
    if (windows == 0) return static_cast<int>(cudaGetLastError());
    const auto st = static_cast<cudaStream_t>(stream);
    auto* w = static_cast<int64_t*>(work);
    cudaError_t err = cudaMemsetAsync(w + 1, 0, (tiles + 1) * sizeof(int64_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    SelectSpec s{static_cast<const int64_t*>(regs), windows, W, skip, shift,
                 static_cast<const int64_t*>(prev_in), static_cast<int64_t*>(prev_out),
                 static_cast<int64_t*>(values), static_cast<int64_t*>(positions), w,
                 reinterpret_cast<unsigned long long*>(w + 1),
                 reinterpret_cast<unsigned long long*>(w + 2)};
    const size_t smem = (kTileWindows + W) * (sizeof(uint64_t) + 2 * sizeof(uint16_t));
    k12_minimizer_kernel<<<static_cast<unsigned>(tiles), kThreads, smem, st>>>(s);
    return static_cast<int>(cudaGetLastError());
}
