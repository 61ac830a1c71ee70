// The kernels' bodies, on groups of lanes: a signature a quad (K-G, K-W) or
// a pair (K-T), a key's chain and then a window a quad (K-B).  The .cu files only
// map threads onto these, so the bodies compile as host C++ as well and the
// CPU tests can run them.
#pragma once

#include "ge25519_quad.cuh"

#define TABLE_NWIN 64
#define TABLE_NDIG 16
// bytes of one window and of one key's table (GE_PRE_BYTES an entry)
#define WINDOW_BYTES (TABLE_NDIG * GE_PRE_BYTES)
#define KEY_BYTES (TABLE_NWIN * WINDOW_BYTES)

FE_FN uint8_t bytes_equal32(const uint8_t *a, const uint8_t *b) {
    uint8_t diff = 0;
    FE_UNROLL
    for (int k = 0; k < 32; k++) diff |= a[k] ^ b[k];
    return diff == 0;
}

// Where verify_joint_quad finds window t of the 127 joint 2-bit windows,
// t = 0 the most significant: K-G derives it from the s and h bytes, K-W
// reads it from the (127, N) int32 windows the caller gives.
struct ScalarWindows {
    const uint8_t *s, *h;
};

FE_FN int window_at(ScalarWindows src, int t) {
    // window j = 126 - t: bits 2j, 2j+1 of s and of h
    int j = 126 - t, byte = j >> 2, shift = (2 * j) & 7;
    return 4 * ((src.s[byte] >> shift) & 3) + ((src.h[byte] >> shift) & 3);
}

// One signature's column of the windows: w[t * stride], stride = N.
struct GivenWindows {
    const int32_t *w;
    int64_t stride;
};

FE_FN int window_at(GivenWindows src, int t) { return src.w[t * src.stride]; }

// K-G and K-W, on a quad (ge25519_quad.cuh): R' = [s]B + [h]C by the 127
// windows w = 4 s_j + h_j, MSB first, with T[4i+j] = iB + jC; then encode
// and compare with R.  Every lane of the quad returns the verdict.
// key: the canonical encodings of (x, y, t) of C = -A, 96 bytes, or null
// for a key index outside the rows: the chain then runs on the identity,
// nothing is read, and the signature is rejected.  A window outside
// [0, 16) is outside the contract: the signature is rejected, and the
// table is never read outside its 16 entries.
template <class Windows>
FE_FN uint8_t verify_joint_quad(Windows src, const uint8_t *r,
                                const uint8_t *key, QTab &tab) {
    QFe c = key ? q_from_affine(fe_frombytes(key), fe_frombytes(key + 32),
                                fe_frombytes(key + 64))
                : q_identity();
    // T[j] = jC
    q_tab_store(tab, 0, q_identity_pre());
    QFe pc = q_to_pre(c);
    q_tab_store(tab, 1, pc);
    QFe c2 = q_dbl(c);
    q_tab_store(tab, 2, q_to_pre(c2));
    q_tab_store(tab, 3, q_to_pre(q_add_pre(c2, pc)));
    // T[4i + j] = iB + jC
    FE_NO_UNROLL
    for (int i = 1; i < 4; i++) {
        QFe b = q_from_affine(GE_B_MULTS[i - 1][0], GE_B_MULTS[i - 1][1],
                              GE_B_MULTS[i - 1][2]);
        q_tab_store(tab, 4 * i, q_to_pre(b));
        FE_NO_UNROLL
        for (int j = 1; j < 4; j++)
            q_tab_store(tab, 4 * i + j,
                        q_to_pre(q_add_pre(b, q_tab_load(tab, j))));
    }
    QFe acc = q_identity();
    int bad = 0;
    FE_NO_UNROLL
    for (int t = 0; t < 127; t++) {
        int w = window_at(src, t);
        bad |= ((unsigned)w > 15u);
        acc = q_dbl(q_dbl(acc));
        acc = q_add_pre(acc, q_tab_load(tab, w & 15));
    }
    uint8_t enc[32];
    q_encode(enc, acc);
    return key != nullptr && !bad && bytes_equal32(enc, r);
}

// The kernels' rows: quad i (K-T: pair i) of the grid verifies signature
// i.  A quad past n (the ragged last warp) runs on row n - 1 and its
// verdict is not stored: every lane must reach every exchange, so none
// returns early.
FE_FN int64_t quad_row(int64_t i, int64_t n) { return i < n ? i : n - 1; }

// K-G: the windows derived from the raw s and h bytes of row quad_row(i, n);
// a key index outside [0, nk) rejects without a read.
FE_FN uint8_t verify_generic_quad(int64_t i, int64_t n, const uint8_t *s,
                                  const uint8_t *h, const uint8_t *r,
                                  const int32_t *key_idx, const uint8_t *keys,
                                  int64_t nk, QTab &tab) {
    int64_t c = quad_row(i, n);
    int32_t k = key_idx[c];
    const uint8_t *key = (k >= 0 && k < nk) ? keys + 96 * (int64_t)k : nullptr;
    return verify_joint_quad(ScalarWindows{s + 32 * c, h + 32 * c},
                             r + 32 * c, key, tab);
}

// K-W: column quad_row(i, n) of the (127, n) windows, its key rows and R.
FE_FN uint8_t verify_windows_quad(int64_t i, int64_t n, const int32_t *windows,
                                  const uint8_t *keys, const uint8_t *r,
                                  QTab &tab) {
    int64_t c = quad_row(i, n);
    return verify_joint_quad(GivenWindows{windows + c, n}, r + 32 * c,
                             keys + 96 * c, tab);
}

// K-W's fused count: lane `lane` of the quad of row i votes in its warp's
// ballot.  Only lane 0 of a quad votes, and only for a row below n, so
// each signature counts once.
FE_FN int quad_vote(int lane, int64_t i, int64_t n, uint8_t ok) {
    return lane == 0 && i < n && ok;
}

// K-B, phase 1, on a warp: the chain S_w = 16^w A, w = 0..63, of the point
// with affine (x, y) = xy[0..63], four doublings between windows as in the
// reference's window scan (stellar_core_tpu/accel/tables.py:51-86), so each
// S_w agrees with the plain version's mod p: 252 doublings a key.  Every
// quad of the warp runs the chain (the shuffles need the whole warp); only
// a quad with `keep` stores S_w as chain entry w.
FE_FN void build_chain_quad(QTab &chain, const uint8_t *xy, bool keep) {
    fe x = fe_frombytes(xy), y = fe_frombytes(xy + 32);
    QFe s = q_from_affine(x, y, fe_mul(x, y));
    if (keep) q_tab_store(chain, 0, s);
    FE_NO_UNROLL
    for (int w = 1; w < TABLE_NWIN; w++) {
        s = q_dbl(q_dbl(q_dbl(q_dbl(s))));
        if (keep) q_tab_store(chain, w, s);
    }
}

// K-B, phase 2, quad w: window w's 16 entries d S, d = 0..15, S = S_w,
// written to out[d * GE_PRE_BYTES] in the resident table's order.  The
// multiples come by 14 repeated adds of S, as the reference's do; the add
// q_add_pre(m, q_to_pre(S)) equals ge_add(m, S) mod p (ge25519_quad.cuh),
// and the bytes are canonical, so every byte equals the plain version's.
FE_FN void build_window_quad(uint8_t *out, const QFe &s) {
    q_pre_store(out, q_identity_pre());
    QFe ps = q_to_pre(s);
    q_pre_store(out + GE_PRE_BYTES, ps);
    QFe m = s;
    FE_NO_UNROLL
    for (int d = 2; d < TABLE_NDIG; d++) {
        m = q_add_pre(m, ps);
        q_pre_store(out + d * GE_PRE_BYTES, q_to_pre(m));
    }
}

// K-T, lane k of a pair: its half of R' = sum_w (B_w[s_w] + (-A)_w[h_w]),
// the windows w = k, k + 2, ..., k + 62: 64 precomputed adds of
// ge25519.cuh, no exchange.  Nibble w of a scalar is (byte[w/2] >> 4(w%2))
// & 15.  With key_tab null the key's entries are left out (its part is the
// identity) and nothing of them is read.
FE_FN ge tables_half(const uint8_t *s, const uint8_t *h, const uint8_t *key_tab,
                     const uint8_t *base_tab, int k) {
    ge acc = ge_identity();
    FE_NO_UNROLL
    for (int w = k; w < TABLE_NWIN; w += 2) {
        int shift = 4 * (w & 1);
        int ds = (s[w >> 1] >> shift) & 15;
        int dh = (h[w >> 1] >> shift) & 15;
        acc = ge_add_pre(acc, ge_pre_load(base_tab + w * WINDOW_BYTES + ds * GE_PRE_BYTES));
        if (key_tab != nullptr)
            acc = ge_add_pre(acc, ge_pre_load(key_tab + w * WINDOW_BYTES + dh * GE_PRE_BYTES));
    }
    return acc;
}

FE_FN PGe p_tables_halves(const uint8_t *s, const uint8_t *h,
                          const uint8_t *key_tab, const uint8_t *base_tab) {
    P_GE_LANEWISE(tables_half(s, h, key_tab, base_tab, k))
}

// K-T: row quad_row(i, n) on pair i.  The group law is associative and the
// formulas complete, so the two halves joined by one complete add are R'
// in both lanes; each lane encodes its copy (one invert, the lanes in
// step) and compares with R.  A slot outside [0, nslots) leaves the key's
// part out, reads nothing of the key table, and rejects the signature.
FE_FN uint8_t verify_tables_pair(int64_t i, int64_t n, const uint8_t *s,
                                 const uint8_t *h, const uint8_t *r,
                                 const int32_t *slots,
                                 const uint8_t *key_table, int64_t nslots,
                                 const uint8_t *base_table) {
    int64_t c = quad_row(i, n);
    int32_t slot = slots[c];
    const uint8_t *key = (slot >= 0 && slot < nslots)
                             ? key_table + (int64_t)slot * KEY_BYTES
                             : nullptr;
    PGe acc = p_tables_halves(s + 32 * c, h + 32 * c, key, base_table);
    acc = p_ge_add(acc, p_ge_swap(acc));
    uint8_t enc[32];
    ge_encode(enc, p_lane0(acc));
    return key != nullptr && bytes_equal32(enc, r + 32 * c);
}

// The chain floor's check (fe_check.cu): `steps` doublings of the point
// with affine (x, y) = xy[0..63] on a quad, in precomputed form (what K-B
// stores of a chain point).
FE_FN QFe dbl_chain_quad(const uint8_t *xy, int64_t steps) {
    fe x = fe_frombytes(xy), y = fe_frombytes(xy + 32);
    QFe p = q_from_affine(x, y, fe_mul(x, y));
    FE_NO_UNROLL
    for (int64_t k = 0; k < steps; k++) p = q_dbl(p);
    return q_to_pre(p);
}

// The field-op check of chip_smoke.py and the tests: op on the elements
// encoded at a and b (bit 255 ignored), result canonical at out.
// 0 mul, 1 square, 2 add, 3 sub, 4 invert(a), 5 canonical(a),
// 6 sixty rounds of a <- a*b - b (a long chain of carried values).
FE_FN void fe_check_one(uint8_t *out, const uint8_t *a, const uint8_t *b,
                        int op) {
    fe x = fe_frombytes(a), y = fe_frombytes(b), r;
    switch (op) {
    case 0: r = fe_mul(x, y); break;
    case 1: r = fe_sq(x); break;
    case 2: r = fe_add(x, y); break;
    case 3: r = fe_sub(x, y); break;
    case 4: r = fe_invert(x); break;
    case 6:
        for (int k = 0; k < 60; k++) x = fe_sub(fe_mul(x, y), y);
        r = x;
        break;
    default: r = x; break;
    }
    fe_tobytes(out, r);
}
