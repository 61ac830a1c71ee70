// K-QF and K-QC: the quorum-intersection enumerator's frontier step.
//
// K-QF (child flags) replaces quorum._prune_step / _child_flags
// (stellar_core_tpu/accel/quorum.py:121-178), which the reference also runs
// inside every depth of _segment_step (:195-271).  One thread a child row,
// the contraction fixpoint the thread's own loop (quorum.cuh).  Bound on the
// H100: __popc throughput (operations); a row is W words read and three
// bytes written, while a fixpoint pass costs (distinct pairs + the top
// masks of the classes the row holds) W popcounts.  Design for Hopper:
// - persistent blocks: the grid is as many blocks as fit on the card at
//   once, each stages the map's tables into shared memory once and then
//   walks rows in a grid-stride loop, so staging does not grow with the
//   rows (a whole asym7 depth is 11.6M of them);
// - node classes: a pass evaluates each distinct inner pair once and then
//   each class of nodes with equal qsets that the row holds once (its top
//   mask there), keeping the row's members of the satisfied classes by a
//   mask (no per-member loop; asym7 is one class);
// - the row and its work rows in registers, the pairs' results too where
//   the map has at most QR_PAIR_WORDS words of pairs (else in shared
//   memory, interleaved by thread).
// Two more paths, chosen by the wrapper from the shapes, for maps the fast
// one does not take (correct, not tuned): rows of more than 8 words (a
// thread's rows and results in a scratch array the wrapper allocates,
// interleaved by thread), and tables too large for shared memory (read in
// place through the read-only data cache, scratch as before).
//
// K-QC (stable frontier compaction) replaces the rest of a depth of
// _segment_step: argsort(~alive) and argsort(~witness) (:239-245), the
// per-depth counts and the overflow freeze (:246-263).  One launch a
// depth, a single pass with decoupled look-back: a block takes the next
// 2048-child tile from an atomic ticket (so every tile before it is running
// or done), counts its alive / witness / quorum bits by warp ballots and
// one warp's scan, publishes its aggregate, looks back over the tiles
// before it for its exclusive prefix, publishes that, and scatters the
// alive rows and the first WCAP witness rows in child order.  A thread
// holds every 256th child of the tile, so a warp's loads and stores cover
// consecutive addresses.  The last tile to finish writes the depth's
// counts and the overflow decision into `meta`.  Bound: bytes (flags read,
// the kept rows' sources read and the kept rows written once).
//
// The segment's state lives on the card in `meta` (int32): [0, 4) quorum
// hits per depth, [4, 8) witnesses per depth, [8] the live count, [9] the
// overflow depth (-1: none), [10] which buffer holds the live frontier (0:
// the segment's input; K-QC sets its destination's number).  A depth reads
// its live count n from meta; child t < n is src[t] and child n + t is
// src[t] | bit, read in place.  Once meta[9] >= 0 every later kernel of the
// segment returns at once: the frontier stays in the buffer meta[10] names.
#include <cuda_runtime.h>

#include <mutex>

#include "quorum.cuh"

namespace {

constexpr int QF_THREADS = 128;
constexpr int QC_THREADS = 256;
constexpr int QC_ITEMS = 8;
constexpr int QC_TILE = QC_THREADS * QC_ITEMS;
constexpr int SEG = 4, WCAP = 8;
constexpr int M_COUNT = 8, M_OVF = 9, M_BUF = 10;
constexpr int64_t MAX_SMEM = 232448;       // what a block may opt in to
enum { PATH_FAST = 0, PATH_WIDE = 1, PATH_GLOBAL = 2 };

using u64 = unsigned long long;   // atomicAdd's 64-bit type

__device__ __forceinline__ int64_t i64min(int64_t a, int64_t b) {
    return a < b ? a : b;
}

// Rows [0, limit) of a launch: `bound`, or in a segment depth (meta given)
// at most twice the live count; -1 if the segment is frozen.
__device__ __forceinline__ int64_t flag_rows(const int32_t *meta,
                                             int64_t bound, int64_t *half) {
    *half = 0;
    if (meta == nullptr) return bound;
    if (meta[M_OVF] >= 0) return -1;
    *half = meta[M_COUNT];
    return i64min(bound, 2 * *half);
}

// Word w of child t: rows[t] (a segment depth: rows[t] or rows[t - half]
// | bit, for t below or above the live count half).
__device__ __forceinline__ uint32_t child_word(const int64_t *rows,
                                               const int64_t *bit, int64_t t,
                                               int64_t half, int nw, int w) {
    if (bit == nullptr) return (uint32_t)rows[t * nw + w];
    return t < half ? (uint32_t)rows[t * nw + w]
                    : (uint32_t)rows[(t - half) * nw + w] | (uint32_t)bit[w];
}

__device__ __forceinline__ void stage(uint32_t *dst, const uint32_t *src,
                                      int64_t n) {
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
    __syncthreads();
}

// The fast path: W words in registers, the tables in shared memory.
template <int W, class X>
__device__ __forceinline__ void flags_rows(
    const int64_t *rows, int64_t limit, int64_t half, const int64_t *bit,
    const int64_t *rem, const int64_t *scc, const QMap<false> &m, X &x,
    uint8_t *alive, uint8_t *is_q, uint8_t *wit) {
    QRow<W> r, s, c, work, keep;
#pragma unroll
    for (int w = 0; w < W; w++) {
        r[w] = (uint32_t)rem[w];
        s[w] = (uint32_t)scc[w];
    }
    for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         t < limit; t += (int64_t)gridDim.x * blockDim.x) {
#pragma unroll
        for (int w = 0; w < W; w++) c[w] = child_word(rows, bit, t, half, W, w);
        int f = q_child_flags<W>(c, r, s, work, keep, m, x);
        alive[t] = (f & Q_ALIVE) != 0;
        is_q[t] = (f & Q_IS_QUORUM) != 0;
        wit[t] = (f & Q_WITNESS) != 0;
    }
}

template <int W, bool REGS>
__global__ void __launch_bounds__(QF_THREADS)
quorum_flags_kernel(const int64_t *__restrict__ rows, int64_t bound,
                    const int32_t *__restrict__ meta,
                    const int64_t *__restrict__ bit,
                    const int64_t *__restrict__ rem,
                    const int64_t *__restrict__ scc,
                    const uint32_t *__restrict__ blob, QDims d,
                    uint8_t *__restrict__ alive, uint8_t *__restrict__ is_q,
                    uint8_t *__restrict__ wit) {
    int64_t half, limit = flag_rows(meta, bound, &half);
    if (limit < 0) return;          // frozen: the same for every block
    extern __shared__ uint32_t q_smem[];
    int64_t nb = q_blob_words(d);
    stage(q_smem, blob, nb);
    QMap<false> m = q_map_at<false>(q_smem, d);
    if constexpr (REGS) {
        QRegScratch x;
        flags_rows<W>(rows, limit, half, bit, rem, scc, m, x, alive, is_q,
                      wit);
    } else {
        // the slice-pass results after the tables, interleaved by thread
        QMemScratch x{q_smem + nb + threadIdx.x, QF_THREADS};
        flags_rows<W>(rows, limit, half, bit, rem, scc, m, x, alive, is_q,
                      wit);
    }
}

// The wide paths: a thread's rows (child, rem, scc, two work rows) and
// results in `scratch`, interleaved over the grid's threads; the tables in
// shared memory (SMEM) or read in place from global memory.
template <bool SMEM>
__global__ void __launch_bounds__(QF_THREADS)
quorum_flags_wide_kernel(const int64_t *__restrict__ rows, int64_t bound,
                         const int32_t *__restrict__ meta,
                         const int64_t *__restrict__ bit,
                         const int64_t *__restrict__ rem,
                         const int64_t *__restrict__ scc,
                         const uint32_t *__restrict__ blob, QDims d,
                         uint32_t *__restrict__ scratch,
                         uint8_t *__restrict__ alive,
                         uint8_t *__restrict__ is_q,
                         uint8_t *__restrict__ wit) {
    int64_t half, limit = flag_rows(meta, bound, &half);
    if (limit < 0) return;
    const uint32_t *tables = blob;
    if constexpr (SMEM) {
        extern __shared__ uint32_t q_smem[];
        stage(q_smem, blob, q_blob_words(d));
        tables = q_smem;
    }
    QMap<!SMEM> m = q_map_at<!SMEM>(tables, d);
    const int nw = d.w;
    const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t nth = (int64_t)gridDim.x * blockDim.x;
    QRow<0> c{scratch + g, nw, nth}, r{scratch + nw * nth + g, nw, nth},
        s{scratch + 2 * nw * nth + g, nw, nth},
        work{scratch + 3 * nw * nth + g, nw, nth},
        keep{scratch + 4 * nw * nth + g, nw, nth};
    QMemScratch x{scratch + 5 * nw * nth + g, nth};
    for (int w = 0; w < nw; w++) {
        r[w] = (uint32_t)rem[w];
        s[w] = (uint32_t)scc[w];
    }
    for (int64_t t = g; t < limit; t += nth) {
        for (int w = 0; w < nw; w++) c[w] = child_word(rows, bit, t, half, nw, w);
        int f = q_child_flags<0>(c, r, s, work, keep, m, x);
        alive[t] = (f & Q_ALIVE) != 0;
        is_q[t] = (f & Q_IS_QUORUM) != 0;
        wit[t] = (f & Q_WITNESS) != 0;
    }
}

// Opt a kernel in to `smem` bytes of dynamic shared memory if it needs
// more than the default.
template <class K>
cudaError_t allow_smem(K kernel, int64_t smem) {
    if (smem > MAX_SMEM) return cudaErrorInvalidValue;
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Persistent grid: the blocks that fit on the card at once, no more than
// the rows need.  The occupancy query costs tens of microseconds, more
// than a small launch, so each (kernel, shared memory, device) is asked
// once; launches may come from several host threads.
struct Occupancy {
    const void *kernel;
    int64_t smem;
    int dev, blocks;
};
std::mutex occupancy_mu;
Occupancy occupancy_seen[64];
int occupancy_n = 0, occupancy_next = 0;   // entries held, next to write

template <class K>
cudaError_t persistent_blocks(K kernel, int64_t smem, int64_t bound,
                              unsigned *blocks) {
    int dev, fit = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const void *key = (const void *)kernel;
    {
        std::lock_guard<std::mutex> hold(occupancy_mu);
        for (int i = 0; i < occupancy_n && !fit; i++) {
            const Occupancy &o = occupancy_seen[i];
            if (o.kernel == key && o.smem == smem && o.dev == dev)
                fit = o.blocks;
        }
    }
    if (!fit) {
        int sms, per_sm;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, QF_THREADS, smem);
        if (e != cudaSuccess) return e;
        fit = sms * (per_sm > 0 ? per_sm : 1);
        std::lock_guard<std::mutex> hold(occupancy_mu);
        occupancy_seen[occupancy_next] = Occupancy{key, smem, dev, fit};
        occupancy_next = (occupancy_next + 1) % 64;
        if (occupancy_n < 64) occupancy_n++;
    }
    int64_t want = (bound + QF_THREADS - 1) / QF_THREADS;
    *blocks = (unsigned)(want < fit ? want : fit);
    return cudaSuccess;
}

template <int W>
int launch_fast(const int64_t *rows, int64_t bound, const int32_t *meta,
                const int64_t *bit, const int64_t *rem, const int64_t *scc,
                const uint32_t *blob, const QDims &d, uint8_t *alive,
                uint8_t *is_q, uint8_t *wit, cudaStream_t stream) {
    bool regs = q_regs_fit(d);
    int64_t smem = q_flags_smem(d, QF_THREADS, !regs);
    auto kernel = regs ? quorum_flags_kernel<W, true>
                       : quorum_flags_kernel<W, false>;
    unsigned blocks;
    cudaError_t e = allow_smem(kernel, smem);
    if (e == cudaSuccess) e = persistent_blocks(kernel, smem, bound, &blocks);
    if (e != cudaSuccess) return (int)e;
    kernel<<<blocks, QF_THREADS, smem, stream>>>(rows, bound, meta, bit, rem,
                                                 scc, blob, d, alive, is_q,
                                                 wit);
    return (int)cudaGetLastError();
}

// K-QC's state, a zeroed array of int64 a depth: [0] the next tile's
// ticket, [1] tiles done, [2] the depth's quorum hits, [3 + i] tile i's
// status: 0 (not yet), ST_AGG | its own counts, or ST_PREFIX | the counts of
// tiles 0..i; counts packed as alive | witnesses << 31.
constexpr u64 ST_AGG = 1ull << 62, ST_PREFIX = 2ull << 62;
constexpr u64 ST_COUNTS = ST_AGG - 1, C31 = (1ull << 31) - 1;
constexpr int QC_WARPS = QC_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// a tile's counts in the block: alive | witnesses << 16 (at most 2048 each)
static_assert(QC_ITEMS * QC_WARPS == 64, "warp 0 scans two entries a lane");

// A tile is QC_ITEMS slices of QC_THREADS children; thread x holds child x
// of each slice, so a warp's flag loads, row reads and (in order) row
// writes each cover consecutive addresses.  Child order is slice by slice:
// a warp's ballot gives each lane its rank in the warp, and warp 0 scans
// the (slice, warp) counts.
__global__ void __launch_bounds__(QC_THREADS)
quorum_compact_kernel(const int64_t *__restrict__ src,
                      const int64_t *__restrict__ bit,
                      const uint8_t *__restrict__ alive,
                      const uint8_t *__restrict__ is_q,
                      const uint8_t *__restrict__ wit,
                      u64 *__restrict__ state, int64_t bound,
                      int64_t capacity, int W, int depth, int dst_id,
                      int32_t *__restrict__ meta, int64_t *__restrict__ dst,
                      int64_t *__restrict__ w_rows) {
    if (meta[M_OVF] >= 0) return;   // frozen by an earlier depth
    __shared__ u64 s_tile, s_prefix;
    __shared__ uint32_t s_cnt[QC_ITEMS * QC_WARPS], s_q[QC_WARPS];
    const int64_t n = meta[M_COUNT];
    const int64_t limit = i64min(bound, 2 * n);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1;
    if (threadIdx.x == 0) s_tile = atomicAdd(&state[0], 1ull);
    __syncthreads();
    const int64_t tile = (int64_t)s_tile;
    const int64_t base = tile * QC_TILE + threadIdx.x;
    unsigned ma[QC_ITEMS], mw[QC_ITEMS], q = 0;
#pragma unroll
    for (int i = 0; i < QC_ITEMS; i++) {
        int64_t t = base + i * QC_THREADS;
        bool a = false, wi = false, qi = false;
        if (t < limit) {
            a = alive[t];
            wi = wit[t];
            qi = is_q[t];
        }
        ma[i] = __ballot_sync(FULL, a);
        mw[i] = __ballot_sync(FULL, wi);
        q += __popc(__ballot_sync(FULL, qi));
        if (lane == 0)
            s_cnt[i * QC_WARPS + warp] = __popc(ma[i]) | __popc(mw[i]) << 16;
    }
    if (lane == 0) s_q[warp] = q;
    __syncthreads();
    if (warp == 0) {
        // exclusive scan of the 64 (slice, warp) counts in child order
        uint32_t e0 = s_cnt[2 * lane], e1 = s_cnt[2 * lane + 1];
        uint32_t x = e0 + e1;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            uint32_t y = __shfl_up_sync(FULL, x, o);
            if (lane >= o) x += y;
        }
        uint32_t ex = x - e0 - e1;
        s_cnt[2 * lane] = ex;
        s_cnt[2 * lane + 1] = ex + e0;
        uint32_t total = __shfl_sync(FULL, x, 31);
        u64 tq = lane < QC_WARPS ? s_q[lane] : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) tq += __shfl_down_sync(FULL, tq, o);
        // publish the aggregate, then look back a warp at a time: lane l
        // reads the status of tile (window top - l); the nearest inclusive
        // prefix ends the walk, else all 32 aggregates add and the window
        // moves back (a tile before 0 reads as an empty prefix).  Each
        // count stays below 2^31, so the packed fields add apart.
        volatile u64 *status = state + 3;
        u64 agg = (u64)(total & 0xffffu) | ((u64)(total >> 16) << 31);
        if (lane == 0)
            status[tile] = (tile == 0 ? u64{ST_PREFIX} : u64{ST_AGG}) | agg;
        u64 prefix = 0;
        for (int64_t top = tile - 1; top >= 0; top -= 32) {
            int64_t j = top - lane;
            u64 st = j >= 0 ? u64{status[j]} : u64{ST_PREFIX};
            while (__any_sync(FULL, st == 0))
                if (st == 0) st = status[j];
            unsigned pre = __ballot_sync(FULL, (st & ST_PREFIX) != 0);
            int stop = pre ? __ffs(pre) - 1 : 31;
            u64 v = lane <= stop ? st & ST_COUNTS : 0;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
            prefix += __shfl_sync(FULL, v, 0);
            if (pre) break;
        }
        if (lane == 0) {
            if (tile > 0) status[tile] = ST_PREFIX | (prefix + agg);
            s_prefix = prefix;
            if (tq) atomicAdd(&state[2], tq);
        }
    }
    __syncthreads();
    const int64_t pre_a = (int64_t)(s_prefix & C31);
    const int64_t pre_w = (int64_t)((s_prefix >> 31) & C31);
#pragma unroll
    for (int i = 0; i < QC_ITEMS; i++) {
        bool a = (ma[i] >> lane) & 1, wi = (mw[i] >> lane) & 1;
        if (!a && !wi) continue;
        uint32_t off = s_cnt[i * QC_WARPS + warp];
        int64_t pos = pre_a + (off & 0xffffu) + __popc(ma[i] & below);
        int64_t wpos = pre_w + (off >> 16) + __popc(mw[i] & below);
        int64_t t = base + i * QC_THREADS;
        const int64_t *row = src + (t < n ? t : t - n) * W;
        for (int w = 0; w < W; w++) {
            int64_t v = row[w] | (t < n ? 0 : bit[w]);
            if (a && pos < capacity) dst[pos * W + w] = v;
            if (wi && wpos < WCAP) w_rows[wpos * W + w] = v;
        }
    }
    // the last tile to finish: every status is an inclusive prefix and
    // every quorum count is in, so the last tile's status is the depth's
    if (threadIdx.x == 0) {
        __threadfence();
        if (atomicAdd(&state[1], 1ull) == gridDim.x - 1) {
            __threadfence();
            u64 last = ((volatile u64 *)state)[3 + gridDim.x - 1];
            int64_t n_alive = (int64_t)(last & C31);
            if (n_alive > capacity) {
                meta[M_OVF] = depth;
            } else {
                meta[depth] = (int32_t)((volatile u64 *)state)[2];
                meta[SEG + depth] = (int32_t)((last >> 31) & C31);
                meta[M_COUNT] = (int32_t)n_alive;
                meta[M_BUF] = dst_id;
            }
        }
    }
}

}  // namespace

extern "C" int quorum_flags_launch(
    const void *rows, int64_t bound, const void *meta, const void *bit,
    const void *rem, const void *scc, const void *blob, int64_t blob_words,
    int n_classes, int n_tops, int n_pairs, int pair_words, int w, int path,
    void *scratch, int64_t scratch_threads, void *alive, void *is_q,
    void *wit, void *stream) {
    if (bound <= 0) return 0;
    QDims d{n_classes, n_tops, n_pairs, pair_words, w};
    // the blob must hold the tables the dims describe (q_blob_words)
    if (blob_words != q_blob_words(d)) return (int)cudaErrorInvalidValue;
    const int64_t *r = (const int64_t *)rows, *b = (const int64_t *)bit,
                  *rm = (const int64_t *)rem, *sc = (const int64_t *)scc;
    const int32_t *mt = (const int32_t *)meta;
    const uint32_t *bl = (const uint32_t *)blob;
    uint8_t *a = (uint8_t *)alive, *q = (uint8_t *)is_q, *wt = (uint8_t *)wit;
    cudaStream_t s = (cudaStream_t)stream;
    if (path == PATH_FAST) {
#define QF_CASE(WW) \
    case WW:        \
        return launch_fast<WW>(r, bound, mt, b, rm, sc, bl, d, a, q, wt, s);
        switch (w) {
            QF_CASE(1) QF_CASE(2) QF_CASE(3) QF_CASE(4)
            QF_CASE(5) QF_CASE(6) QF_CASE(7) QF_CASE(8)
            default: return (int)cudaErrorInvalidValue;
        }
#undef QF_CASE
    }
    if ((path != PATH_WIDE && path != PATH_GLOBAL) || scratch == nullptr ||
        scratch_threads <= 0 || scratch_threads % QF_THREADS != 0)
        return (int)cudaErrorInvalidValue;
    unsigned blocks = (unsigned)(scratch_threads / QF_THREADS);
    uint32_t *x = (uint32_t *)scratch;
    if (path == PATH_WIDE) {
        int64_t smem = 4 * q_blob_words(d);
        cudaError_t e = allow_smem(quorum_flags_wide_kernel<true>, smem);
        if (e != cudaSuccess) return (int)e;
        quorum_flags_wide_kernel<true><<<blocks, QF_THREADS, smem, s>>>(
            r, bound, mt, b, rm, sc, bl, d, x, a, q, wt);
    } else {
        quorum_flags_wide_kernel<false><<<blocks, QF_THREADS, 0, s>>>(
            r, bound, mt, b, rm, sc, bl, d, x, a, q, wt);
    }
    return (int)cudaGetLastError();
}

// state: a zeroed array of 3 + ceil(bound / 2048) int64.
extern "C" int quorum_compact_launch(const void *src, const void *bit,
                                     const void *alive, const void *is_q,
                                     const void *wit, void *state,
                                     int64_t bound, int64_t capacity, int w,
                                     int depth, int dst_id, void *meta,
                                     void *dst, void *w_rows, void *stream) {
    if (bound <= 0) return 0;
    unsigned tiles = (unsigned)((bound + QC_TILE - 1) / QC_TILE);
    quorum_compact_kernel<<<tiles, QC_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t *)src, (const int64_t *)bit, (const uint8_t *)alive,
        (const uint8_t *)is_q, (const uint8_t *)wit, (u64 *)state, bound,
        capacity, w, depth, dst_id, (int32_t *)meta, (int64_t *)dst,
        (int64_t *)w_rows);
    return (int)cudaGetLastError();
}

extern "C" const char *cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
