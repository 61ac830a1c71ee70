// Host build of the CUDA kernels' per-thread bodies
// (stellar_core_tpu_torch/csrc/verify.cuh, ge25519_quad.cuh, quorum.cuh) for
// tests/test_torch_csrc.py: each entry loops over its rows the way the
// kernel's threads (or quads of threads) map onto them in verify_generic.cu
// (K-G, K-W), tables.cu (K-B, K-T), fe_check.cu and quorum.cu.
#include <vector>

#include "quorum.cuh"
#include "verify.cuh"

namespace {

// K-QF's rows, with the map's tables as the tensors hold them (int64
// words) turned into the 32-bit words of the kernel's shared-memory copy,
// and one row's scratch (stride 1).
template <int W>
void quorum_flags_rows(const int64_t *rows, int64_t b, const int64_t *rem,
                       const int64_t *scc, int n, int n_tops, int n_pairs,
                       int pair_words, const int32_t *top_thr,
                       const int32_t *top_of, const int64_t *tops,
                       const int32_t *pair_thr, const int64_t *pairs,
                       const int64_t *node_pairs, uint8_t *out) {
    std::vector<uint32_t> tops32(tops, tops + n_tops * W);
    std::vector<uint32_t> pairs32(pairs, pairs + n_pairs * W);
    std::vector<uint32_t> np32(node_pairs, node_pairs + n * pair_words);
    std::vector<uint32_t> ok(pair_words + 1);
    std::vector<uint16_t> hits(n_tops);
    QMap m{n, n_tops, n_pairs, pair_words, top_thr, top_of, tops32.data(),
           pair_thr, pairs32.data(), np32.data()};
    QScratch x{ok.data(), hits.data(), 1};
    uint32_t r[W], s[W], c[W];
    for (int w = 0; w < W; w++) {
        r[w] = (uint32_t)rem[w];
        s[w] = (uint32_t)scc[w];
    }
    for (int64_t i = 0; i < b; i++) {
        for (int w = 0; w < W; w++) c[w] = (uint32_t)rows[i * W + w];
        out[i] = (uint8_t)q_child_flags<W>(c, r, s, m, x);
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

// Per row: Q_ALIVE | Q_IS_QUORUM | Q_WITNESS bits; returns -1 for a W the
// kernel is not built for.
int host_quorum_flags(const int64_t *rows, int64_t b, int w,
                      const int64_t *rem, const int64_t *scc, int n,
                      int n_tops, int n_pairs, int pair_words,
                      const int32_t *top_thr, const int32_t *top_of,
                      const int64_t *tops, const int32_t *pair_thr,
                      const int64_t *pairs, const int64_t *node_pairs,
                      uint8_t *out) {
    switch (w) {
#define HQ_CASE(WW)                                                         \
    case WW:                                                                \
        quorum_flags_rows<WW>(rows, b, rem, scc, n, n_tops, n_pairs,        \
                              pair_words, top_thr, top_of, tops, pair_thr,  \
                              pairs, node_pairs, out);                      \
        return 0;
        HQ_CASE(1) HQ_CASE(2) HQ_CASE(3) HQ_CASE(4)
        HQ_CASE(5) HQ_CASE(6) HQ_CASE(7) HQ_CASE(8)
#undef HQ_CASE
        default: return -1;
    }
}

int64_t host_quorum_flags_smem(int n, int n_tops, int n_pairs, int pair_words,
                               int w, int threads) {
    return q_flags_smem(n, n_tops, n_pairs, pair_words, w, threads);
}

}  // extern "C"
