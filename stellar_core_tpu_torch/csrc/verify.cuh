// Per-thread bodies of the three kernels: one signature (K-G, K-T) or one
// (key, window) (K-B).  The .cu files only map threads onto these, so the
// bodies compile as host C++ as well and the CPU tests can run them.
#pragma once

#include "ge25519.cuh"

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

// K-G: R' = [s]B + [h]C by 127 joint 2-bit windows, MSB first, with
// T[4i+j] = iB + jC; then encode and compare with R.
// key: the canonical encodings of (x, y, t) of C = -A, 96 bytes.
FE_FN uint8_t verify_generic_one(const uint8_t *s, const uint8_t *h,
                                 const uint8_t *r, const uint8_t *key) {
    ge c;
    c.X = fe_frombytes(key);
    c.Y = fe_frombytes(key + 32);
    c.Z = fe_one();
    c.T = fe_frombytes(key + 64);
    ge cm[4];
    cm[0] = ge_identity();
    cm[1] = c;
    cm[2] = ge_dbl(c);
    cm[3] = ge_add(cm[2], c);
    ge_pre tab[16];
    for (int j = 0; j < 4; j++) tab[j] = ge_to_pre(cm[j]);
    for (int i = 1; i < 4; i++) {
        ge b;
        b.X = GE_B_MULTS[i - 1][0];
        b.Y = GE_B_MULTS[i - 1][1];
        b.Z = fe_one();
        b.T = GE_B_MULTS[i - 1][2];
        tab[4 * i] = ge_to_pre(b);
        for (int j = 1; j < 4; j++) tab[4 * i + j] = ge_to_pre(ge_add(b, cm[j]));
    }
    ge acc = ge_identity();
    FE_NO_UNROLL
    for (int j = 126; j >= 0; j--) {
        // window j: bits 2j, 2j+1 of s and of h
        int byte = j >> 2, shift = (2 * j) & 7;
        int w = 4 * ((s[byte] >> shift) & 3) + ((h[byte] >> shift) & 3);
        acc = ge_dbl(ge_dbl(acc));
        acc = ge_add_pre(acc, tab[w]);
    }
    uint8_t enc[32];
    ge_encode(enc, acc);
    return bytes_equal32(enc, r);
}

// K-B: window w of the table of the point with affine (x, y) = xy[0..63]:
// the 16 entries d * 16^w * A, d = 0..15, written to out[d * GE_PRE_BYTES].
// 16^w * A comes from 4w doublings of A: the same chain as the plain
// version's window scan, so the coordinates agree mod p.  (A sequential
// chain over the windows would need 252 doublings a key; this one runs
// 8,064, the price of one thread per window.)
FE_FN void build_window_one(uint8_t *out, const uint8_t *xy, int w) {
    ge s = ge_from_affine(fe_frombytes(xy), fe_frombytes(xy + 32));
    FE_NO_UNROLL
    for (int i = 0; i < 4 * w; i++) s = ge_dbl(s);
    ge_pre_store(out, ge_to_pre(ge_identity()));
    ge_pre_store(out + GE_PRE_BYTES, ge_to_pre(s));
    ge m = s;
    FE_NO_UNROLL
    for (int d = 2; d < TABLE_NDIG; d++) {
        m = ge_add(m, s);
        ge_pre_store(out + d * GE_PRE_BYTES, ge_to_pre(m));
    }
}

// K-T: R' = [s]B + [h](-A) by 64 windows of two precomputed adds (no
// doublings); then encode and compare with R.  Nibble w of a scalar is
// (byte[w/2] >> 4(w%2)) & 15.
FE_FN uint8_t verify_tables_one(const uint8_t *s, const uint8_t *h,
                                const uint8_t *r, const uint8_t *key_tab,
                                const uint8_t *base_tab) {
    ge acc = ge_identity();
    FE_NO_UNROLL
    for (int w = 0; w < TABLE_NWIN; w++) {
        int shift = 4 * (w & 1);
        int ds = (s[w >> 1] >> shift) & 15;
        int dh = (h[w >> 1] >> shift) & 15;
        acc = ge_add_pre(acc, ge_pre_load(base_tab + w * WINDOW_BYTES + ds * GE_PRE_BYTES));
        acc = ge_add_pre(acc, ge_pre_load(key_tab + w * WINDOW_BYTES + dh * GE_PRE_BYTES));
    }
    uint8_t enc[32];
    ge_encode(enc, acc);
    return bytes_equal32(enc, r);
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
