// Host build of the CUDA kernels' per-thread bodies
// (stellar_core_tpu_torch/csrc/verify.cuh, quorum.cuh) for
// tests/test_torch_csrc.py: each entry loops over its rows the way the
// kernel's threads map onto them in verify_generic.cu (K-G, K-W), tables.cu,
// fe_check.cu and quorum.cu.
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

void host_verify_generic(const uint8_t *s, const uint8_t *h, const uint8_t *r,
                         const int32_t *key_idx, int64_t n,
                         const uint8_t *keys, int64_t nk, uint8_t *out) {
    for (int64_t i = 0; i < n; i++) {
        int32_t k = key_idx[i];
        out[i] = (k < 0 || k >= nk) ? 0
                 : verify_generic_one(s + 32 * i, h + 32 * i, r + 32 * i,
                                      keys + 96 * (int64_t)k);
    }
}

// K-W: the windows (127, n) int32, MSB first; per signature its key rows.
void host_verify_windows(const int32_t *windows, const uint8_t *keys,
                         const uint8_t *r, int64_t n, uint8_t *out) {
    for (int64_t i = 0; i < n; i++)
        out[i] = verify_joint_one(GivenWindows{windows + i, n}, r + 32 * i,
                                  keys + 96 * i);
}

void host_build_tables(const uint8_t *key_xy, const int32_t *slots, int64_t k,
                       uint8_t *table, int64_t nslots) {
    for (int64_t key = 0; key < k; key++) {
        int32_t slot = slots[key];
        if (slot < 0 || slot >= nslots) continue;
        for (int w = 0; w < TABLE_NWIN; w++)
            build_window_one(table + (int64_t)slot * KEY_BYTES + w * WINDOW_BYTES,
                             key_xy + 64 * key, w);
    }
}

void host_verify_tables(const uint8_t *s, const uint8_t *h, const uint8_t *r,
                        const int32_t *slots, int64_t n,
                        const uint8_t *key_table, int64_t nslots,
                        const uint8_t *base_table, uint8_t *out) {
    for (int64_t i = 0; i < n; i++) {
        int32_t slot = slots[i];
        out[i] = (slot < 0 || slot >= nslots) ? 0
                 : verify_tables_one(s + 32 * i, h + 32 * i, r + 32 * i,
                                     key_table + (int64_t)slot * KEY_BYTES,
                                     base_table);
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
