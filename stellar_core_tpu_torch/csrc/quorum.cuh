// Per-row body of the quorum-intersection enumerator's flag kernel (K-QF):
// the slice check, the contraction to the greatest quorum, and the three
// flags of one child mask.  Compiles as CUDA device code (quorum.cu) and as
// host C++ (tests/torch_csrc_host.cpp), like fe25519.cuh.
//
// A node set is W 32-bit words: bit b of word w is node 32 w + b, the
// order of quorum.py's pack_bits and masks_to_words.  The map comes in the
// form quorum.py's flag_tables makes of herder/quorum_intersection.py's
// flatten_qmap: each distinct top mask and each distinct inner (mask,
// threshold) pair once, and the nodes grouped into classes of equal (top
// threshold, top mask, pairs), each with the mask of its members.  A slice
// pass evaluates each distinct inner pair once on the row, then each class
// with a member in the row once (its top mask's popcount and its satisfied
// pairs), and keeps the row's members of the satisfied classes: no
// per-member loop, and no work for a class the row does not hold.  asym7,
// tier1, org and flat maps are one class.
//
// The tables travel as one array of 32-bit words (q_blob_words), copied
// as it is into shared memory or read in place from global memory.  A
// row's words and its scratch are registers where the width is a template
// constant (W = 1..8) or a thread's slot in a scratch array (W = 0: the
// width is QDims::w, for maps of more than 256 nodes).
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define QHD __host__ __device__ __forceinline__
#else
#define QHD inline
#endif

// The most pair words whose per-row results K-QF keeps in registers (more
// go to shared memory): asym7, tier1, org and flat maps have at most 64
// distinct pairs.
constexpr int QR_PAIR_WORDS = 2;

QHD int q_popc(uint32_t x) {
#if defined(__CUDA_ARCH__)
    return __popc(x);
#else
    return __builtin_popcount(x);
#endif
}

struct QDims {
    int n_classes, n_tops, n_pairs, pair_words, w;
};

// The tables as one array of 32-bit words, in this order: class_thr [C],
// class_top [C], pair_thr [P], class_pairs [C, PW], tops [T, W],
// pairs [P, W], members [C, W].  quorum.py's blob_words is the same sum.
QHD int64_t q_blob_words(const QDims &d) {
    return 2 * (int64_t)d.n_classes + d.n_pairs +
           (int64_t)d.n_classes * d.pair_words +
           (int64_t)(d.n_tops + d.n_pairs + d.n_classes) * d.w;
}

// Do a row's slice-pass results fit the register scratch?
QHD bool q_regs_fit(const QDims &d) { return d.pair_words <= QR_PAIR_WORDS; }

// Bytes of shared memory the tables-in-shared-memory kernels take: the
// tables, and each of `threads` rows' slice-pass results unless they are
// in registers (a 32-bit word a pair word).  quorum.py's flags_smem_bytes
// is the same sum.
QHD int64_t q_flags_smem(const QDims &d, int threads, bool scratch_in_smem) {
    return 4 * q_blob_words(d) +
           (scratch_in_smem ? 4 * (int64_t)threads * d.pair_words : 0);
}

// 32-bit words of the wide kernels' per-thread scratch: the row, the
// remaining mask, the scc, two work rows, and the slice-pass results.
QHD int64_t q_wide_scratch_words(const QDims &d) {
    return 5 * (int64_t)d.w + d.pair_words;
}

// The map's tables; LDG: read through the read-only data cache (tables in
// global memory), else plain loads (shared memory, or the host).
template <bool LDG>
struct QMap {
    QDims d;
    const uint32_t *class_thr, *class_top, *pair_thr, *class_pairs, *tops,
        *pairs, *members;
    QHD uint32_t at(const uint32_t *p, int64_t i) const {
#if defined(__CUDA_ARCH__)
        if (LDG) return __ldg(p + i);
#endif
        return p[i];
    }
};

template <bool LDG>
QHD QMap<LDG> q_map_at(const uint32_t *blob, const QDims &d) {
    QMap<LDG> m;
    m.d = d;
    m.class_thr = blob;
    m.class_top = m.class_thr + d.n_classes;
    m.pair_thr = m.class_top + d.n_classes;
    m.class_pairs = m.pair_thr + d.n_pairs;
    m.tops = m.class_pairs + (int64_t)d.n_classes * d.pair_words;
    m.pairs = m.tops + (int64_t)d.n_tops * d.w;
    m.members = m.pairs + (int64_t)d.n_pairs * d.w;
    return m;
}

// A node set of W words in registers.
template <int W>
struct QRow {
    uint32_t v[W];
    QHD int size() const { return W; }
    QHD uint32_t &operator[](int i) { return v[i]; }
    QHD uint32_t operator[](int i) const { return v[i]; }
};

// A node set of w words: a thread's slot in scratch, words `stride` apart
// (the threads of a grid interleave theirs, so a warp's accesses coalesce).
template <>
struct QRow<0> {
    uint32_t *p;
    int w;
    int64_t stride;
    QHD int size() const { return w; }
    QHD uint32_t &operator[](int i) { return p[i * stride]; }
    QHD uint32_t operator[](int i) const { return p[i * stride]; }
};

// A row's slice-pass results in registers: one bit a pair (its threshold
// met); the selects unroll over the fixed size, so no index is dynamic.
struct QRegScratch {
    uint32_t ok[QR_PAIR_WORDS];
    QHD uint32_t get_ok(int pw) const {
        uint32_t b = 0;
#pragma unroll
        for (int i = 0; i < QR_PAIR_WORDS; i++) b = i == pw ? ok[i] : b;
        return b;
    }
    QHD void set_ok(int pw, uint32_t b) {
#pragma unroll
        for (int i = 0; i < QR_PAIR_WORDS; i++) ok[i] = i == pw ? b : ok[i];
    }
};

// The same in memory (shared or global), entries `stride` apart.
struct QMemScratch {
    uint32_t *ok;
    int64_t stride;
    QHD uint32_t get_ok(int pw) const { return ok[pw * stride]; }
    QHD void set_ok(int pw, uint32_t b) const { ok[pw * stride] = b; }
};

// The slice pass's pair evaluations on s: n_pairs W popcounts.
template <int W, class M, class X>
QHD void q_eval(const QRow<W> &s, const M &m, X &x) {
    const int nw = s.size();
    for (int pw = 0; pw < m.d.pair_words; pw++) {
        uint32_t bits = 0;
        int end = m.d.n_pairs - 32 * pw < 32 ? m.d.n_pairs - 32 * pw : 32;
        for (int b = 0; b < end; b++) {
            int p = 32 * pw + b;
            uint32_t c = 0;
#pragma unroll
            for (int w = 0; w < nw; w++)
                c += q_popc(s[w] & m.at(m.pairs, (int64_t)p * nw + w));
            bits |= (uint32_t)(c >= m.at(m.pair_thr, p)) << b;
        }
        x.set_ok(pw, bits);
    }
}

// Does s (its pairs evaluated in x) satisfy class c's slice: its top
// mask's popcount in s plus its satisfied pairs, against its top threshold?
template <int W, class M, class X>
QHD bool q_class_ok(const QRow<W> &s, int c, const M &m, const X &x) {
    const int nw = s.size();
    const int64_t top = (int64_t)m.at(m.class_top, c) * nw;
    uint32_t hits = 0;
#pragma unroll
    for (int w = 0; w < nw; w++) hits += q_popc(s[w] & m.at(m.tops, top + w));
    for (int pw = 0; pw < m.d.pair_words; pw++)
        hits += q_popc(x.get_ok(pw) &
                       m.at(m.class_pairs, (int64_t)c * m.d.pair_words + pw));
    return (int32_t)hits >= (int32_t)m.at(m.class_thr, c);
}

// keep <- s & the members of every class whose slice s satisfies; returns
// whether keep differs from s.  A class with no member in s adds nothing
// and is not evaluated: a class costs W loads unless the row holds it.
template <int W, class M, class X>
QHD bool q_keep(const QRow<W> &s, QRow<W> &keep, const M &m, const X &x) {
    const int nw = s.size();
#pragma unroll
    for (int w = 0; w < nw; w++) keep[w] = 0;
    for (int c = 0; c < m.d.n_classes; c++) {
        uint32_t present = 0;
#pragma unroll
        for (int w = 0; w < nw; w++)
            present |= s[w] & m.at(m.members, (int64_t)c * nw + w);
        if (present && q_class_ok<W>(s, c, m, x)) {
#pragma unroll
            for (int w = 0; w < nw; w++)
                keep[w] |= m.at(m.members, (int64_t)c * nw + w);
        }
    }
    bool changed = false;
#pragma unroll
    for (int w = 0; w < nw; w++) {
        uint32_t k = keep[w] & s[w];
        keep[w] = k;
        changed |= k != s[w];
    }
    return changed;
}

// s <- the greatest quorum inside s (0 if none): repeat "keep the members
// whose slice s satisfies" until nothing changes.  Each pass tests every
// member against the same s, as the batched reference does; the fixpoint is
// unique, so a thread's own loop ends where the reference's while_loop
// leaves this row.  `keep` is a work row.
template <int W, class M, class X>
QHD void q_contract(QRow<W> &s, QRow<W> &keep, const M &m, X &x) {
    const int nw = s.size();
    for (;;) {
        bool any = false;
#pragma unroll
        for (int w = 0; w < nw; w++) any |= s[w] != 0;
        if (!any) return;
        q_eval<W>(s, m, x);
        if (!q_keep<W>(s, keep, m, x)) return;
#pragma unroll
        for (int w = 0; w < nw; w++) s[w] = keep[w];
    }
}

enum { Q_ALIVE = 1, Q_IS_QUORUM = 2, Q_WITNESS = 4 };

// quorum.py's child_flags for one child: dead (the child is not inside
// the greatest quorum of child | rem, or there is none), is_q (every
// member's slice is satisfied inside the child, one pass), witness (is_q
// and scc & ~child contains a quorum; that fixpoint runs only on is_q
// rows).  work and keep are work rows.  Returns Q_ALIVE (= !dead && !is_q)
// | Q_IS_QUORUM | Q_WITNESS bits.
template <int W, class M, class X>
QHD int q_child_flags(const QRow<W> &child, const QRow<W> &rem,
                      const QRow<W> &scc, QRow<W> &work, QRow<W> &keep,
                      const M &m, X &x) {
    const int nw = child.size();
    bool outside = false, any_mq = false, any_child = false;
#pragma unroll
    for (int w = 0; w < nw; w++) work[w] = child[w] | rem[w];
    q_contract<W>(work, keep, m, x);
#pragma unroll
    for (int w = 0; w < nw; w++) {
        outside |= (child[w] & ~work[w]) != 0;
        any_mq |= work[w] != 0;
        any_child |= child[w] != 0;
    }
    bool dead = outside || !any_mq;
    bool is_q = false;
    if (any_child) {
        q_eval<W>(child, m, x);
        is_q = !q_keep<W>(child, keep, m, x);
    }
    bool wit = false;
    if (is_q) {
#pragma unroll
        for (int w = 0; w < nw; w++) work[w] = scc[w] & ~child[w];
        q_contract<W>(work, keep, m, x);
#pragma unroll
        for (int w = 0; w < nw; w++) wit |= work[w] != 0;
    }
    return (!dead && !is_q ? Q_ALIVE : 0) | (is_q ? Q_IS_QUORUM : 0) |
           (wit ? Q_WITNESS : 0);
}
