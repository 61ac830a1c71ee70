// Per-row body of the quorum-intersection enumerator's flag kernel (K-QF):
// the slice check, the contraction to the greatest quorum, and the three
// flags of one child mask.  Compiles as CUDA device code (quorum.cu) and as
// host C++ (tests/torch_csrc_host.cpp), like fe25519.cuh.
//
// A node set is W 32-bit words: bit b of word w is node 32 w + b, the
// order of quorum.py's pack_bits and masks_to_words.  The map comes in the
// form quorum.py's flag_tables makes of herder/quorum_intersection.py's
// flatten_qmap: each distinct top mask and each distinct inner (mask,
// threshold) pair once, and per node its top threshold, the index of its
// top mask and a bitmask of its pairs.  An org's inner set recurs in every
// node's qset, so a slice pass evaluates each distinct set once for the
// whole row and then sums each member's share from those results.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define QHD __host__ __device__ __forceinline__
#else
#define QHD inline
#endif

QHD int q_popc(uint32_t x) {
#if defined(__CUDA_ARCH__)
    return __popc(x);
#else
    return __builtin_popcount(x);
#endif
}

QHD int q_ctz(uint32_t x) {   // x != 0
#if defined(__CUDA_ARCH__)
    return __ffs(x) - 1;
#else
    return __builtin_ctz(x);
#endif
}

// The map's tables (32-bit words).
struct QMap {
    int n, n_tops, n_pairs, pair_words;
    const int32_t *top_thr;      // [n]
    const int32_t *top_of;       // [n]: index into tops
    const uint32_t *tops;        // [n_tops, W]
    const int32_t *pair_thr;     // [n_pairs]
    const uint32_t *pairs;       // [n_pairs, W]
    const uint32_t *node_pairs;  // [n, pair_words]: bit p = the node's pair p
};

// One row's results of a slice pass: the popcount of each top mask and one
// bit a pair (its threshold met), entries `stride` apart (the threads of a
// block interleave theirs in shared memory).
struct QScratch {
    uint32_t *ok;     // [pair_words]
    uint16_t *hits;   // [n_tops]
    int stride;
};

// Bytes of K-QF's shared memory: the tables as 32-bit words and each of
// `threads` rows' scratch.  quorum.py's flags_smem_bytes is the same sum.
QHD int64_t q_flags_smem(int n, int n_tops, int n_pairs, int pair_words,
                         int w, int threads) {
    return 4 * ((int64_t)2 * n + (int64_t)n * pair_words + n_pairs +
                (int64_t)(n_tops + n_pairs) * w +
                (int64_t)pair_words * threads) +
           2 * (int64_t)n_tops * threads;
}

// The slice pass's set evaluations on s: (n_tops + n_pairs) W popcounts.
template <int W>
QHD void q_eval(const uint32_t (&s)[W], const QMap &m, const QScratch &x) {
    for (int u = 0; u < m.n_tops; u++) {
        int c = 0;
#pragma unroll
        for (int w = 0; w < W; w++) c += q_popc(s[w] & m.tops[u * W + w]);
        x.hits[u * x.stride] = (uint16_t)c;
    }
    for (int pw = 0; pw < m.pair_words; pw++) {
        uint32_t bits = 0;
        int end = m.n_pairs - 32 * pw < 32 ? m.n_pairs - 32 * pw : 32;
        for (int b = 0; b < end; b++) {
            int p = 32 * pw + b;
            int c = 0;
#pragma unroll
            for (int w = 0; w < W; w++) c += q_popc(s[w] & m.pairs[p * W + w]);
            bits |= (uint32_t)(c >= m.pair_thr[p]) << b;
        }
        x.ok[pw * x.stride] = bits;
    }
}

// Does the evaluated set contain a slice of node i's qset?  Its top mask's
// popcount plus its satisfied pairs, against its top threshold.
QHD bool q_node_ok(const QMap &m, const QScratch &x, int i) {
    int hits = x.hits[m.top_of[i] * x.stride];
    for (int pw = 0; pw < m.pair_words; pw++)
        hits += q_popc(x.ok[pw * x.stride] & m.node_pairs[i * m.pair_words + pw]);
    return hits >= m.top_thr[i];
}

// s <- the greatest quorum inside s (0 if none): repeat "keep the members
// whose slice s satisfies" until nothing changes.  Each pass tests every
// member against the same s, as the batched reference does; the fixpoint is
// unique, so a thread's own loop ends where the reference's while_loop
// leaves this row.
template <int W>
QHD void q_contract(uint32_t (&s)[W], const QMap &m, const QScratch &x) {
    for (;;) {
        bool any = false;
#pragma unroll
        for (int w = 0; w < W; w++) any |= s[w] != 0;
        if (!any) return;
        q_eval<W>(s, m, x);
        uint32_t keep[W];
        bool changed = false;
#pragma unroll
        for (int w = 0; w < W; w++) {
            uint32_t mw = s[w], kw = 0;
            while (mw) {
                int b = q_ctz(mw);
                mw &= mw - 1;
                if (q_node_ok(m, x, 32 * w + b)) kw |= 1u << b;
            }
            keep[w] = kw;
            changed |= kw != s[w];
        }
        if (!changed) return;
#pragma unroll
        for (int w = 0; w < W; w++) s[w] = keep[w];
    }
}

enum { Q_ALIVE = 1, Q_IS_QUORUM = 2, Q_WITNESS = 4 };

// quorum.py's child_flags for one child: dead (the child is not inside
// the greatest quorum of child | rem, or there is none), is_q (every
// member's slice is satisfied inside the child, one pass), witness (is_q
// and scc & ~child contains a quorum; that fixpoint runs only on is_q
// rows).  Returns Q_ALIVE (= !dead && !is_q) | Q_IS_QUORUM | Q_WITNESS bits.
template <int W>
QHD int q_child_flags(const uint32_t (&child)[W], const uint32_t (&rem)[W],
                      const uint32_t (&scc)[W], const QMap &m,
                      const QScratch &x) {
    uint32_t mq[W];
    bool outside = false, any_mq = false, any_child = false, unsat = false;
#pragma unroll
    for (int w = 0; w < W; w++) mq[w] = child[w] | rem[w];
    q_contract<W>(mq, m, x);
#pragma unroll
    for (int w = 0; w < W; w++) {
        outside |= (child[w] & ~mq[w]) != 0;
        any_mq |= mq[w] != 0;
        any_child |= child[w] != 0;
    }
    bool dead = outside || !any_mq;
    if (any_child) {
        q_eval<W>(child, m, x);
#pragma unroll
        for (int w = 0; w < W; w++) {
            uint32_t mw = child[w];
            while (mw) {
                int b = q_ctz(mw);
                mw &= mw - 1;
                unsat |= !q_node_ok(m, x, 32 * w + b);
            }
        }
    }
    bool is_q = any_child && !unsat;
    bool wit = false;
    if (is_q) {
        uint32_t comp[W];
#pragma unroll
        for (int w = 0; w < W; w++) comp[w] = scc[w] & ~child[w];
        q_contract<W>(comp, m, x);
#pragma unroll
        for (int w = 0; w < W; w++) wit |= comp[w] != 0;
    }
    return (!dead && !is_q ? Q_ALIVE : 0) | (is_q ? Q_IS_QUORUM : 0) |
           (wit ? Q_WITNESS : 0);
}
