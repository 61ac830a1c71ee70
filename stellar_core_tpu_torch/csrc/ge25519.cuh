// Edwards25519 points in extended coordinates (X, Y, Z, T), one per thread.
//
// Replaces stellar_core_tpu/accel/curve.py's point_dbl (:81-89), point_add
// (:92-102), _B_MULTS (:105-122) and point_encode (:174-184), and
// tables.py's point_add_precomp (:89-103).  The formulas are the same
// complete a = -1 formulas (RFC 8032 section 5.1.4), written in the same
// order, so a point computed here has the same projective coordinates mod p
// as the plain version's: K-B's table entries compare equal as canonical
// values, not only as points.
//
// Precomputed entries (ge_pre) hold (Y-X, Y+X, 2d*T, 2Z): adding one costs
// 8 field multiplies instead of the full add's 9.
#pragma once

#include "fe25519.cuh"

struct ge {
    fe X, Y, Z, T;
};

struct ge_pre {
    fe ymx, ypx, t2d, z2;
};

// 2d, and the affine (x, y, x*y) of B, 2B, 3B, in the limb layout of
// fe25519.cuh (tests/test_torch_csrc.py checks them against curve.py)
FE_CONST fe GE_D2 = {{0x2b2f159, 0x1a6e509, 0x22add7a, 0x0d4141d, 0x0038052,
                      0x0f3d130, 0x3407977, 0x19ce331, 0x1c56dff, 0x0901b67}};

FE_CONST fe GE_B_MULTS[3][3] = {
    {{{0x325d51a, 0x18b5823, 0x0f6592a, 0x104a92d, 0x1a4b31d,
       0x1d6dc5c, 0x27118fe, 0x07fd814, 0x13cd6e5, 0x085a4db}},
     {{0x2666658, 0x1999999, 0x0cccccc, 0x1333333, 0x1999999,
       0x0666666, 0x3333333, 0x0cccccc, 0x2666666, 0x1999999}},
     {{0x1b7dda3, 0x1a2ace9, 0x25eadbb, 0x003ba8a, 0x083c27e,
       0x0abe37d, 0x1274732, 0x0ccacdd, 0x0fd78b7, 0x19e1d7c}}},
    {{{0x043ce0e, 0x168538a, 0x08bf078, 0x028aebd, 0x0203639,
       0x033e7ac, 0x21dbe8c, 0x08d87a0, 0x0c9f5a0, 0x0daace1}},
     {{0x2f8a3c9, 0x1d1ab9a, 0x22ac1cb, 0x08b21c2, 0x25ce43d,
       0x1a21f56, 0x12f7464, 0x13843b4, 0x3309232, 0x0898337}},
     {{0x169b401, 0x08fd55b, 0x08056e3, 0x04e0fb9, 0x175e6b3,
       0x103b413, 0x2af8439, 0x11b83bc, 0x050b2f6, 0x092629e}}},
    {{{0x3f8e25c, 0x09217f4, 0x110d58c, 0x0cc0b12, 0x18d0e60,
       0x0dac83a, 0x2573a1f, 0x1e923fe, 0x0a22928, 0x19eba71}},
     {{0x0f5b4d4, 0x0da121e, 0x0608058, 0x0bb3920, 0x27c5bb0,
       0x0269ef7, 0x350c730, 0x1357424, 0x1177ee6, 0x0499ec7}},
     {{0x0b3a41a, 0x0423e9e, 0x38959bf, 0x05fd8b7, 0x1709cd6,
       0x1b91527, 0x39bc1d6, 0x0a21d7d, 0x1cb1dd9, 0x0a93409}}},
};

FE_FN ge ge_identity() {
    ge r;
    r.X = fe_zero();
    r.Y = fe_one();
    r.Z = fe_one();
    r.T = fe_zero();
    return r;
}

// affine (x, y) -> extended (x, y, 1, x*y)
FE_FN ge ge_from_affine(const fe &x, const fe &y) {
    ge r;
    r.X = x;
    r.Y = y;
    r.Z = fe_one();
    r.T = fe_mul(x, y);
    return r;
}

FE_FN ge ge_dbl(const ge &p) {
    fe A = fe_sq(p.X);
    fe B = fe_sq(p.Y);
    fe zz = fe_sq(p.Z);
    fe C = fe_add(zz, zz);
    fe H = fe_add(A, B);
    fe E = fe_sub(H, fe_sq(fe_add(p.X, p.Y)));
    fe G = fe_sub(A, B);
    fe F = fe_add(C, G);
    ge r;
    r.X = fe_mul(E, F);
    r.Y = fe_mul(G, H);
    r.Z = fe_mul(F, G);
    r.T = fe_mul(E, H);
    return r;
}

FE_FN ge ge_add(const ge &p, const ge &q) {
    fe A = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
    fe B = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
    fe C = fe_mul(fe_mul(p.T, q.T), GE_D2);
    fe ZZ = fe_mul(p.Z, q.Z);
    fe Dd = fe_add(ZZ, ZZ);
    fe E = fe_sub(B, A);
    fe F = fe_sub(Dd, C);
    fe G = fe_add(Dd, C);
    fe H = fe_add(B, A);
    ge r;
    r.X = fe_mul(E, F);
    r.Y = fe_mul(G, H);
    r.Z = fe_mul(F, G);
    r.T = fe_mul(E, H);
    return r;
}

FE_FN ge_pre ge_to_pre(const ge &p) {
    ge_pre e;
    e.ymx = fe_sub(p.Y, p.X);
    e.ypx = fe_add(p.Y, p.X);
    e.t2d = fe_mul(p.T, GE_D2);
    e.z2 = fe_add(p.Z, p.Z);
    return e;
}

FE_FN ge ge_add_pre(const ge &p, const ge_pre &e) {
    fe A = fe_mul(fe_sub(p.Y, p.X), e.ymx);
    fe B = fe_mul(fe_add(p.Y, p.X), e.ypx);
    fe C = fe_mul(p.T, e.t2d);
    fe Dd = fe_mul(p.Z, e.z2);
    fe E = fe_sub(B, A);
    fe F = fe_sub(Dd, C);
    fe G = fe_add(Dd, C);
    fe H = fe_add(B, A);
    ge r;
    r.X = fe_mul(E, F);
    r.Y = fe_mul(G, H);
    r.Z = fe_mul(F, G);
    r.T = fe_mul(E, H);
    return r;
}

// canonical encoding: y little-endian with x's parity in bit 255
FE_FN void ge_encode(uint8_t *s, const ge &p) {
    fe zinv = fe_invert(p.Z);
    fe x = fe_mul(p.X, zinv);
    fe y = fe_mul(p.Y, zinv);
    fe_tobytes(s, y);
    s[31] |= (uint8_t)(fe_isodd(x) << 7);
}

// A table entry as stored: the canonical 32-byte encodings of (Y-X, Y+X,
// 2d*T, 2Z), 128 bytes, 16-byte aligned.  The limb layout stays inside the
// kernels; the plain versions read the same bytes.
#define GE_PRE_BYTES 128

FE_FN void ge_pre_store(uint8_t *dst, const ge_pre &e) {
    fe_store(dst, e.ymx);
    fe_store(dst + 32, e.ypx);
    fe_store(dst + 64, e.t2d);
    fe_store(dst + 96, e.z2);
}

FE_FN ge_pre ge_pre_load(const uint8_t *src) {
    ge_pre e;
    e.ymx = fe_load(src);
    e.ypx = fe_load(src + 32);
    e.t2d = fe_load(src + 64);
    e.z2 = fe_load(src + 96);
    return e;
}
