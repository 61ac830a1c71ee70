// Host build of the CUDA kernels' per-thread bodies
// (stellar_core_tpu_torch/csrc/verify.cuh, ge25519_quad.cuh, quorum.cuh) for
// tests/test_torch_csrc.py: each entry loops over its rows the way the
// kernel's threads (or quads of threads) map onto them in verify_generic.cu
// (K-G, K-W), tables.cu (K-B, K-T), fe_check.cu and quorum.cu.
#include <vector>

#include "quorum.cuh"
#include "verify.cuh"

namespace {

// K-QF's bodies, looping over rows the way the kernels' threads do.  The
// fast body: W words and the work rows in registers, the slice-pass
// results in registers (QRegScratch) or in memory (stride 1).
template <int W, class X>
void quorum_fast_rows(const int64_t *rows, int64_t b, const int64_t *rem,
                      const int64_t *scc, const QMap<false> &m, X &x,
                      uint8_t *out) {
    QRow<W> r, s, c, work, keep;
    for (int w = 0; w < W; w++) {
        r[w] = (uint32_t)rem[w];
        s[w] = (uint32_t)scc[w];
    }
    for (int64_t i = 0; i < b; i++) {
        for (int w = 0; w < W; w++) c[w] = (uint32_t)rows[i * W + w];
        out[i] = (uint8_t)q_child_flags<W>(c, r, s, work, keep, m, x);
    }
}

template <int W>
int quorum_fast(const int64_t *rows, int64_t b, const int64_t *rem,
                const int64_t *scc, const uint32_t *blob, const QDims &d,
                bool regs, uint8_t *out) {
    QMap<false> m = q_map_at<false>(blob, d);
    if (regs) {
        if (!q_regs_fit(d)) return -1;
        QRegScratch x;
        quorum_fast_rows<W>(rows, b, rem, scc, m, x, out);
    } else {
        std::vector<uint32_t> mem(d.pair_words + 1);
        QMemScratch x{mem.data(), 1};
        quorum_fast_rows<W>(rows, b, rem, scc, m, x, out);
    }
    return 0;
}

// The wide body: any width, a thread's rows and results in a scratch array
// with WIDE_THREADS threads interleaved, thread g taking rows g, g +
// WIDE_THREADS, ...; LDG: the global-table accessor.
constexpr int WIDE_THREADS = 3;

template <bool LDG>
void quorum_wide(const int64_t *rows, int64_t b, const int64_t *rem,
                 const int64_t *scc, const uint32_t *blob, const QDims &d,
                 uint8_t *out) {
    QMap<LDG> m = q_map_at<LDG>(blob, d);
    const int nw = d.w;
    const int64_t nth = WIDE_THREADS;
    std::vector<uint32_t> scratch(q_wide_scratch_words(d) * nth, 0xA5A5A5A5u);
    uint32_t *sp = scratch.data();
    for (int64_t g = 0; g < nth; g++) {
        QRow<0> c{sp + g, nw, nth}, r{sp + nw * nth + g, nw, nth},
            s{sp + 2 * nw * nth + g, nw, nth},
            work{sp + 3 * nw * nth + g, nw, nth},
            keep{sp + 4 * nw * nth + g, nw, nth};
        QMemScratch x{sp + 5 * nw * nth + g, nth};
        for (int w = 0; w < nw; w++) {
            r[w] = (uint32_t)rem[w];
            s[w] = (uint32_t)scc[w];
        }
        for (int64_t t = g; t < b; t += nth) {
            for (int w = 0; w < nw; w++) c[w] = (uint32_t)rows[t * nw + w];
            out[t] = (uint8_t)q_child_flags<0>(c, r, s, work, keep, m, x);
        }
    }
}

}  // namespace

extern "C" {

void host_fe_check(const uint8_t *a, const uint8_t *b, int op, int64_t n,
                   uint8_t *out) {
    for (int64_t i = 0; i < n; i++) fe_check_one(out + 32 * i, a + 32 * i, b + 32 * i, op);
}

// K-G and K-W run a quad of lanes a signature, K-T a pair; here a QTab and
// a QFe hold the quad's four lanes, a PGe the pair's two, and the loops run
// whole warps (8 quads, 16 pairs), rows past n included, as the kernels'
// grids do.
#define QUADS_PER_WARP 8

static int64_t warp_rows(int64_t n) {
    return (n + QUADS_PER_WARP - 1) / QUADS_PER_WARP * QUADS_PER_WARP;
}

void host_verify_generic(const uint8_t *s, const uint8_t *h, const uint8_t *r,
                         const int32_t *key_idx, int64_t n,
                         const uint8_t *keys, int64_t nk, uint8_t *out) {
    QTab tab;
    for (int64_t i = 0; i < warp_rows(n); i++) {
        uint8_t ok = verify_generic_quad(i, n, s, h, r, key_idx, keys, nk, tab);
        if (i < n) out[i] = ok;
    }
}

// K-W: the windows (127, n) int32, MSB first; per signature its key rows.
// With count, the per-warp ballot of the fused count: each of a warp's 32
// lanes votes quad_vote, and the warp adds the number of votes.
void host_verify_windows(const int32_t *windows, const uint8_t *keys,
                         const uint8_t *r, int64_t n, uint8_t *out,
                         int32_t *count) {
    QTab tab;
    int votes = 0;
    for (int64_t i = 0; i < warp_rows(n); i++) {
        uint8_t ok = verify_windows_quad(i, n, windows, keys, r, tab);
        if (i < n) out[i] = ok;
        for (int lane = 0; lane < 4; lane++) votes += quad_vote(lane, i, n, ok);
        if (i % QUADS_PER_WARP == QUADS_PER_WARP - 1) {
            if (count != nullptr) *count += votes;
            votes = 0;
        }
    }
}

// The quad point operations against the single-thread ones, on raw limbs
// (any carried values, on the curve or not: both sides compute the same
// polynomials).  Per case 8 elements of 10 limbs: the point X, Y, Z, T and
// an entry Y-X, Y+X, 2Z, 2dT in the quad layout; out, 16 canonical
// encodings: q_dbl, ge_dbl, q_add_pre, ge_add_pre.
void host_quad_point_ops(const uint32_t *limbs, int64_t n, uint8_t *out) {
    for (int64_t c = 0; c < n; c++) {
        fe v[8];
        memcpy(v, limbs + 80 * c, sizeof v);
        QFe p = q_sel(v[0], v[1], v[2], v[3]), e = q_sel(v[4], v[5], v[6], v[7]);
        ge g{v[0], v[1], v[2], v[3]};
        ge_pre ep{v[4], v[5], v[7], v[6]};
        QFe qd = q_dbl(p), qa = q_add_pre(p, e);
        ge gd = ge_dbl(g), ga = ge_add_pre(g, ep);
        const fe got[16] = {qd.v[0], qd.v[1], qd.v[2], qd.v[3], gd.X, gd.Y,
                            gd.Z, gd.T, qa.v[0], qa.v[1], qa.v[2], qa.v[3],
                            ga.X, ga.Y, ga.Z, ga.T};
        for (int k = 0; k < 16; k++) fe_tobytes(out + 32 * (16 * c + k), got[k]);
    }
}

// K-B: a block a key; phase 1 (warp 0's chain into the block's chain
// buffer), then phase 2 (quad w writes window w).
void host_build_tables(const uint8_t *key_xy, const int32_t *slots, int64_t k,
                       uint8_t *table, int64_t nslots) {
    QTab chain;
    for (int64_t key = 0; key < k; key++) {
        int32_t slot = slots[key];
        if (slot < 0 || slot >= nslots) continue;
        build_chain_quad(chain, key_xy + 64 * key, true);
        for (int w = 0; w < TABLE_NWIN; w++)
            build_window_quad(table + (int64_t)slot * KEY_BYTES + w * WINDOW_BYTES,
                              q_tab_load(chain, w));
    }
}

// K-T: a pair of lanes a signature, in whole warps of 16 pairs.
void host_verify_tables(const uint8_t *s, const uint8_t *h, const uint8_t *r,
                        const int32_t *slots, int64_t n,
                        const uint8_t *key_table, int64_t nslots,
                        const uint8_t *base_table, uint8_t *out) {
    for (int64_t i = 0; i < (n + 15) / 16 * 16; i++) {
        uint8_t ok = verify_tables_pair(i, n, s, h, r, slots, key_table,
                                        nslots, base_table);
        if (i < n) out[i] = ok;
    }
}

// The chain-floor check kernel: steps doublings of each row's point, in
// whole warps, its precomputed form at out[128 i].
void host_dbl_chain(const uint8_t *xy, int64_t n, int64_t steps,
                    uint8_t *out) {
    for (int64_t i = 0; i < warp_rows(n); i++) {
        QFe p = dbl_chain_quad(xy + 64 * quad_row(i, n), steps);
        if (i < n) q_pre_store(out + GE_PRE_BYTES * i, p);
    }
}

// Per row: Q_ALIVE | Q_IS_QUORUM | Q_WITNESS bits of K-QF's body `body`:
// 0 the fast one with its results in registers, 1 the fast one with them
// in memory, 2 the wide one reading the tables plainly (as from shared
// memory), 3 the wide one through the global-table accessor.  Returns -1
// for a body that does not take the map.
int host_quorum_flags(const int64_t *rows, int64_t b, const int64_t *rem,
                      const int64_t *scc, const uint32_t *blob,
                      int n_classes, int n_tops, int n_pairs, int pair_words,
                      int w, int body, uint8_t *out) {
    QDims d{n_classes, n_tops, n_pairs, pair_words, w};
    if (body == 2 || body == 3) {
        if (body == 2)
            quorum_wide<false>(rows, b, rem, scc, blob, d, out);
        else
            quorum_wide<true>(rows, b, rem, scc, blob, d, out);
        return 0;
    }
    switch (w) {
#define HQ_CASE(WW) \
    case WW:        \
        return quorum_fast<WW>(rows, b, rem, scc, blob, d, body == 0, out);
        HQ_CASE(1) HQ_CASE(2) HQ_CASE(3) HQ_CASE(4)
        HQ_CASE(5) HQ_CASE(6) HQ_CASE(7) HQ_CASE(8)
#undef HQ_CASE
        default: return -1;
    }
}

// quorum.cuh's sizes, for the wrapper's copies of them: [blob words,
// registers fit, shared memory with the results there, without them, the
// wide scratch words a thread].
void host_quorum_sizes(int n_classes, int n_tops, int n_pairs,
                       int pair_words, int w, int threads, int64_t *out) {
    QDims d{n_classes, n_tops, n_pairs, pair_words, w};
    out[0] = q_blob_words(d);
    out[1] = q_regs_fit(d);
    out[2] = q_flags_smem(d, threads, true);
    out[3] = q_flags_smem(d, threads, false);
    out[4] = q_wide_scratch_words(d);
}

}  // extern "C"
