// K-QF and K-QC: the quorum-intersection enumerator's frontier step.
//
// K-QF (child flags) replaces quorum._prune_step / _child_flags
// (stellar_core_tpu/accel/quorum.py:121-178), which the reference also runs
// inside every depth of _segment_step (:195-271).  One thread per child
// row: the row's W words stay in registers, the map's deduplicated tables
// (quorum.py's flag_tables) and each thread's slice-pass results sit in
// shared memory, and the contraction fixpoint is the thread's own loop
// (quorum.cuh).  Bound on the H100: __popc throughput (operations); a row
// is W words read and three bytes written, while a fixpoint pass costs
// (distinct tops + distinct pairs) W popcounts.
//
// K-QC (stable frontier compaction) replaces the rest of a depth of
// _segment_step: argsort(~alive) and argsort(~witness) (:239-245), the
// per-depth counts and the overflow freeze (:246-263).  Three passes: a
// block count of each 2048-child tile, one block's exclusive scan of the
// tile counts (which also updates the depth's counts in `meta` and decides
// the overflow), and a scatter that scans each tile again and writes the
// alive rows and the first WCAP witness rows in child order.  The scans
// are written out with __shfl_up_sync.  Bound: bytes (flags read, rows
// read and written once).
//
// The segment's state lives on the card in `meta` (int32): [0, 4) quorum
// hits per depth, [4, 8) witnesses per depth, [8] the live count, [9] the
// overflow depth (-1: none), [10] the count the depth started from.  A depth
// reads its live count n from meta; child t < n is src[t] and child n + t
// is src[t] | bit, read in place.  Once meta[9] >= 0 every later kernel of
// the segment only copies the frozen frontier through, so the host learns
// where the frontier is without a sync.
#include <cuda_runtime.h>

#include "quorum.cuh"

namespace {

constexpr int QF_THREADS = 128;
constexpr int QC_THREADS = 256;
constexpr int QC_ITEMS = 8;
constexpr int QC_TILE = QC_THREADS * QC_ITEMS;
constexpr int QC_SCAN_THREADS = 1024;
constexpr int SEG = 4, WCAP = 8;
constexpr int M_COUNT = 8, M_OVF = 9, M_PREV = 10;
constexpr int64_t MAX_SMEM = 232448;       // what a block may opt in to

using u64 = unsigned long long;   // __shfl_up_sync's 64-bit type

__device__ __forceinline__ int64_t i64min(int64_t a, int64_t b) {
    return a < b ? a : b;
}

// The map's tables as the wrapper hands them over (masks as int64 words
// with 32 bits used).
struct QMapIn {
    int n, n_tops, n_pairs, pair_words;
    const int32_t *top_thr, *top_of;
    const int64_t *tops;
    const int32_t *pair_thr;
    const int64_t *pairs, *node_pairs;
};

template <int W>
__global__ void __launch_bounds__(QF_THREADS)
quorum_flags_kernel(const int64_t *__restrict__ rows, int64_t bound,
                    const int32_t *__restrict__ meta,
                    const int64_t *__restrict__ bit,
                    const int64_t *__restrict__ rem,
                    const int64_t *__restrict__ scc, QMapIn in,
                    uint8_t *__restrict__ alive, uint8_t *__restrict__ is_q,
                    uint8_t *__restrict__ wit) {
    int64_t limit = bound, half = 0;
    if (meta != nullptr) {          // a segment depth
        if (meta[M_OVF] >= 0) return;   // frozen: the same for the block
        half = meta[M_COUNT];
        limit = i64min(limit, 2 * half);
    }
    // shared memory: the tables as 32-bit words, then the threads' scratch
    // (entries interleaved by thread, so a warp's accesses hit 32 banks)
    extern __shared__ uint32_t q_smem[];
    int32_t *s_top_thr = (int32_t *)q_smem;
    int32_t *s_top_of = s_top_thr + in.n;
    int32_t *s_pair_thr = s_top_of + in.n;
    uint32_t *s_node_pairs = (uint32_t *)(s_pair_thr + in.n_pairs);
    uint32_t *s_tops = s_node_pairs + in.n * in.pair_words;
    uint32_t *s_pairs = s_tops + in.n_tops * W;
    uint32_t *s_ok = s_pairs + in.n_pairs * W;
    uint16_t *s_hits = (uint16_t *)(s_ok + in.pair_words * QF_THREADS);
    for (int i = threadIdx.x; i < in.n; i += blockDim.x) {
        s_top_thr[i] = in.top_thr[i];
        s_top_of[i] = in.top_of[i];
    }
    for (int i = threadIdx.x; i < in.n_pairs; i += blockDim.x)
        s_pair_thr[i] = in.pair_thr[i];
    for (int i = threadIdx.x; i < in.n * in.pair_words; i += blockDim.x)
        s_node_pairs[i] = (uint32_t)in.node_pairs[i];
    for (int i = threadIdx.x; i < in.n_tops * W; i += blockDim.x)
        s_tops[i] = (uint32_t)in.tops[i];
    for (int i = threadIdx.x; i < in.n_pairs * W; i += blockDim.x)
        s_pairs[i] = (uint32_t)in.pairs[i];
    __syncthreads();
    int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= limit) return;
    QMap m{in.n, in.n_tops, in.n_pairs, in.pair_words, s_top_thr, s_top_of,
           s_tops, s_pair_thr, s_pairs, s_node_pairs};
    QScratch x{s_ok + threadIdx.x, s_hits + threadIdx.x, QF_THREADS};
    uint32_t c[W], r[W], s[W];
    if (meta != nullptr) {
        const int64_t *row = rows + (t < half ? t : t - half) * W;
#pragma unroll
        for (int w = 0; w < W; w++)
            c[w] = (uint32_t)row[w] | (t < half ? 0u : (uint32_t)bit[w]);
    } else {
#pragma unroll
        for (int w = 0; w < W; w++) c[w] = (uint32_t)rows[t * W + w];
    }
#pragma unroll
    for (int w = 0; w < W; w++) {
        r[w] = (uint32_t)rem[w];
        s[w] = (uint32_t)scc[w];
    }
    int f = q_child_flags<W>(c, r, s, m, x);
    alive[t] = (f & Q_ALIVE) != 0;
    is_q[t] = (f & Q_IS_QUORUM) != 0;
    wit[t] = (f & Q_WITNESS) != 0;
}

template <int W>
int launch_flags(const int64_t *rows, int64_t bound, const int32_t *meta,
                 const int64_t *bit, const int64_t *rem, const int64_t *scc,
                 const QMapIn &in, uint8_t *alive, uint8_t *is_q,
                 uint8_t *wit, cudaStream_t stream) {
    unsigned blocks = (unsigned)((bound + QF_THREADS - 1) / QF_THREADS);
    int64_t smem = q_flags_smem(in.n, in.n_tops, in.n_pairs, in.pair_words,
                                W, QF_THREADS);
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            quorum_flags_kernel<W>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    quorum_flags_kernel<W><<<blocks, QF_THREADS, smem, stream>>>(
        rows, bound, meta, bit, rem, scc, in, alive, is_q, wit);
    return (int)cudaGetLastError();
}

// Exclusive prefix of v over the block, and the block's total in *total;
// blockDim.x is a multiple of 32.
__device__ u64 block_scan(u64 v, u64 *total) {
    __shared__ u64 warp_sum[32];
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int nwarps = blockDim.x >> 5;
    u64 x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        u64 y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
        u64 s = lane < nwarps ? warp_sum[lane] : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            u64 y = __shfl_up_sync(0xffffffffu, s, o);
            if (lane >= o) s += y;
        }
        if (lane < nwarps) warp_sum[lane] = s;
    }
    __syncthreads();
    u64 before = warp > 0 ? warp_sum[warp - 1] : 0;
    *total = warp_sum[nwarps - 1];
    __syncthreads();                 // warp_sum is reused by the next call
    return before + x - v;
}

// Tile counts are packed as alive | witnesses << 32.
__global__ void __launch_bounds__(QC_THREADS)
compact_count_kernel(const uint8_t *__restrict__ alive,
                     const uint8_t *__restrict__ is_q,
                     const uint8_t *__restrict__ wit,
                     const int32_t *__restrict__ meta, int64_t bound,
                     u64 *__restrict__ tile_aw,
                     u64 *__restrict__ tile_q) {
    if (meta[M_OVF] >= 0) return;
    int64_t limit = i64min(bound, 2 * (int64_t)meta[M_COUNT]);
    int64_t base = (int64_t)blockIdx.x * QC_TILE + threadIdx.x * QC_ITEMS;
    u64 aw = 0, q = 0;
#pragma unroll
    for (int i = 0; i < QC_ITEMS; i++) {
        int64_t t = base + i;
        if (t < limit) {
            aw += alive[t] | ((u64)wit[t] << 32);
            q += is_q[t];
        }
    }
    u64 total_aw, total_q;
    block_scan(aw, &total_aw);
    block_scan(q, &total_q);
    if (threadIdx.x == 0) {
        tile_aw[blockIdx.x] = total_aw;
        tile_q[blockIdx.x] = total_q;
    }
}

// One block: tile_aw becomes each tile's exclusive offset; the depth's
// totals go to meta, or the overflow depth if the alive rows exceed the
// capacity (then the count stays and the depth's counts stay 0).
__global__ void __launch_bounds__(QC_SCAN_THREADS)
compact_scan_kernel(u64 *__restrict__ tile_aw,
                    const u64 *__restrict__ tile_q, int tiles,
                    int32_t *__restrict__ meta, int depth, int64_t capacity) {
    if (meta[M_OVF] >= 0) return;
    u64 carry = 0, q = 0;
    for (int base = 0; base < tiles; base += blockDim.x) {
        int b = base + threadIdx.x;
        u64 total, total_q;
        u64 ex = block_scan(b < tiles ? tile_aw[b] : 0, &total);
        block_scan(b < tiles ? tile_q[b] : 0, &total_q);
        if (b < tiles) tile_aw[b] = carry + ex;
        carry += total;
        q += total_q;
    }
    if (threadIdx.x == 0) {
        int64_t n_alive = (int64_t)(carry & 0xffffffffu);
        meta[M_PREV] = meta[M_COUNT];
        if (n_alive > capacity) {
            meta[M_OVF] = depth;
        } else {
            meta[depth] = (int32_t)q;
            meta[SEG + depth] = (int32_t)(carry >> 32);
            meta[M_COUNT] = (int32_t)n_alive;
        }
    }
}

__global__ void __launch_bounds__(QC_THREADS)
compact_scatter_kernel(const int64_t *__restrict__ src,
                       const int64_t *__restrict__ bit,
                       const uint8_t *__restrict__ alive,
                       const uint8_t *__restrict__ wit,
                       const u64 *__restrict__ tile_off,
                       const int32_t *__restrict__ meta, int64_t bound,
                       int64_t capacity, int W, int64_t *__restrict__ dst,
                       int64_t *__restrict__ w_rows) {
    int64_t base = (int64_t)blockIdx.x * QC_TILE + threadIdx.x * QC_ITEMS;
    if (meta[M_OVF] >= 0) {
        // frozen by an overflow at this depth or an earlier one: the next
        // frontier is this one, copied through
        int64_t n = meta[M_COUNT];
        for (int i = 0; i < QC_ITEMS; i++) {
            int64_t t = base + i;
            if (t < n)
                for (int w = 0; w < W; w++) dst[t * W + w] = src[t * W + w];
        }
        return;
    }
    int64_t n = meta[M_PREV];
    int64_t limit = i64min(bound, 2 * n);
    unsigned fa = 0, fw = 0;
#pragma unroll
    for (int i = 0; i < QC_ITEMS; i++) {
        int64_t t = base + i;
        if (t < limit) {
            fa |= (unsigned)alive[t] << i;
            fw |= (unsigned)wit[t] << i;
        }
    }
    u64 total;
    u64 off = block_scan((u64)__popc(fa) | ((u64)__popc(fw) << 32),
                              &total) + tile_off[blockIdx.x];
    int64_t pos = (int64_t)(off & 0xffffffffu), wpos = (int64_t)(off >> 32);
    for (int i = 0; i < QC_ITEMS; i++) {
        bool a = (fa >> i) & 1, wi = (fw >> i) & 1;
        if (!a && !wi) continue;
        int64_t t = base + i;
        const int64_t *row = src + (t < n ? t : t - n) * W;
        for (int w = 0; w < W; w++) {
            int64_t v = row[w] | (t < n ? 0 : bit[w]);
            if (a && pos < capacity) dst[pos * W + w] = v;
            if (wi && wpos < WCAP) w_rows[wpos * W + w] = v;
        }
        pos += a;
        wpos += wi;
    }
}

}  // namespace

extern "C" int quorum_flags_launch(
    const void *rows, int64_t bound, const void *meta, const void *bit,
    const void *rem, const void *scc, int n, int n_tops, int n_pairs,
    int pair_words, int w, const void *top_thr, const void *top_of,
    const void *tops, const void *pair_thr, const void *pairs,
    const void *node_pairs, void *alive, void *is_q, void *wit,
    void *stream) {
    if (bound <= 0) return 0;
    QMapIn in{n, n_tops, n_pairs, pair_words, (const int32_t *)top_thr,
              (const int32_t *)top_of, (const int64_t *)tops,
              (const int32_t *)pair_thr, (const int64_t *)pairs,
              (const int64_t *)node_pairs};
#define QF_CASE(WW)                                                          \
    case WW:                                                                 \
        return launch_flags<WW>(                                             \
            (const int64_t *)rows, bound, (const int32_t *)meta,             \
            (const int64_t *)bit, (const int64_t *)rem, (const int64_t *)scc, \
            in, (uint8_t *)alive, (uint8_t *)is_q, (uint8_t *)wit,           \
            (cudaStream_t)stream);
    switch (w) {
        QF_CASE(1) QF_CASE(2) QF_CASE(3) QF_CASE(4)
        QF_CASE(5) QF_CASE(6) QF_CASE(7) QF_CASE(8)
        default: return (int)cudaErrorInvalidValue;
    }
#undef QF_CASE
}

// tiles: scratch of 2 * ceil(bound / 2048) uint64 words.
extern "C" int quorum_compact_launch(const void *src, const void *bit,
                                     const void *alive, const void *is_q,
                                     const void *wit, void *tiles,
                                     int64_t bound, int64_t capacity, int w,
                                     int depth, void *meta, void *dst,
                                     void *w_rows, void *stream) {
    if (bound <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    int n_tiles = (int)((bound + QC_TILE - 1) / QC_TILE);
    u64 *tile_aw = (u64 *)tiles, *tile_q = tile_aw + n_tiles;
    compact_count_kernel<<<n_tiles, QC_THREADS, 0, s>>>(
        (const uint8_t *)alive, (const uint8_t *)is_q, (const uint8_t *)wit,
        (const int32_t *)meta, bound, tile_aw, tile_q);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    compact_scan_kernel<<<1, QC_SCAN_THREADS, 0, s>>>(
        tile_aw, tile_q, n_tiles, (int32_t *)meta, depth, capacity);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    compact_scatter_kernel<<<n_tiles, QC_THREADS, 0, s>>>(
        (const int64_t *)src, (const int64_t *)bit, (const uint8_t *)alive,
        (const uint8_t *)wit, tile_aw, (const int32_t *)meta, bound,
        capacity, w, (int64_t *)dst, (int64_t *)w_rows);
    return (int)cudaGetLastError();
}

extern "C" const char *cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
