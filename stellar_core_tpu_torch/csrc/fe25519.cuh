// GF(2^255-19) arithmetic for one element per thread.
//
// Replaces the JAX package's field layer (stellar_core_tpu/accel/field.py):
// fe_carry (:51-61), fe_add/fe_sub (:79-88), fe_mul (:91-100),
// fe_invert (:111-126) and fe_canonical (:129-163).  Those functions are
// inlined into every device program there; here they are device functions
// inlined into the kernels K-G (verify_generic.cu), K-B and K-T (tables.cu).
//
// Layout: 10 unsigned limbs of 26, 25, 26, ... bits (ref10's radix
// 2^25.5); limb i starts at bit ceil(25.5 i).  The H100 has no 64x64-bit
// multiplier, but a 32x32->64 product is one IMAD.WIDE, so a product of two
// elements is 100 of them (55 for a square), summed in uint64 columns.
// Products landing at bit 255 or above fold back by 2^255 = 19 (mod p).
//
// Bounds (all limbs non-negative; nothing is ever negative, so every shift
// is a plain unsigned carry):
//   * "carried": the output of fe_carry and so of every op below.  Limb i
//     is < 2^w_i (w_i = 26, 25, 26, ...), except limb 1, which may exceed
//     2^25 by the last carry out of limb 0: < 2^25 + 2^15.  So every limb
//     is < 2^26.01 (even) or < 2^25.01 (odd).
//   * fe_mul / fe_sq take carried inputs.  A term is (f_i, doubled when i
//     and j are both odd) * (g_j, times 19 when folded):
//     <= 2^26.01 * 19 * 2^26.01 < 2^56.3, and a column of ten < 2^59.7,
//     inside uint64.  fe_sq also doubles cross terms: left factor
//     <= 4 * 2^25.01 = 2^27.01 (still a uint32), term < 2^57.3, column of
//     ten < 2^60.7.  19 * g_j < 2^30.3 is a uint32 too.
//   * fe_add / fe_sub carry their result, so any chain of ops keeps the
//     carried bound: no lazy reduction, unlike the JAX layout, whose
//     headroom proof (field.py:64-76) holds only for its 16-bit limbs.
//     fe_sub adds 2p limbwise (2p_i >= 2^26 - 2 >= any carried limb) so
//     f + 2p - g is non-negative in every limb before the carry.
//   * fe_tobytes reduces fully to [0, p): two carry passes give limbs all
//     below their widths (value < 2^255), then one conditional subtract of
//     p, decided by whether value + 19 carries out of bit 255.
//
// The header also compiles as host C++ (no __CUDACC__), so the CPU tests
// can hold this code against the plain PyTorch version without a card.
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define FE_FN __device__ __forceinline__
#define FE_CONST __constant__
#define FE_UNROLL _Pragma("unroll")
#define FE_NO_UNROLL _Pragma("unroll 1")
#else
#define FE_FN static inline
#define FE_CONST static const
#define FE_UNROLL
#define FE_NO_UNROLL
#endif

#define FE_NLIMB 10

struct fe {
    uint32_t v[FE_NLIMB];
};

// limb i is 26 bits wide for even i, 25 for odd i
#define FE_WIDTH(i) (26 - ((i) & 1))
#define FE_MASK(i) ((1u << FE_WIDTH(i)) - 1u)

FE_FN fe fe_zero() {
    fe r;
    FE_UNROLL
    for (int i = 0; i < FE_NLIMB; i++) r.v[i] = 0;
    return r;
}

FE_FN fe fe_one() {
    fe r = fe_zero();
    r.v[0] = 1;
    return r;
}

// Carry uint64 columns (each < 2^63) into a carried element: limbs 0..9 in
// order, limb 9's carry folds into limb 0 times 19, then limb 0 carries
// once more into limb 1.
FE_FN fe fe_carry(uint64_t h[FE_NLIMB]) {
    FE_UNROLL
    for (int i = 0; i < FE_NLIMB - 1; i++) {
        h[i + 1] += h[i] >> FE_WIDTH(i);
        h[i] &= FE_MASK(i);
    }
    h[0] += 19 * (h[9] >> 25);
    h[9] &= FE_MASK(9);
    h[1] += h[0] >> 26;
    h[0] &= FE_MASK(0);
    fe r;
    FE_UNROLL
    for (int i = 0; i < FE_NLIMB; i++) r.v[i] = (uint32_t)h[i];
    return r;
}

FE_FN fe fe_add(const fe &f, const fe &g) {
    uint64_t h[FE_NLIMB];
    FE_UNROLL
    for (int i = 0; i < FE_NLIMB; i++) h[i] = (uint64_t)f.v[i] + g.v[i];
    return fe_carry(h);
}

FE_FN fe fe_sub(const fe &f, const fe &g) {
    // limbs of 2p: 2(2^26 - 19), then 2(2^25 - 1), 2(2^26 - 1), ...
    uint64_t h[FE_NLIMB];
    FE_UNROLL
    for (int i = 0; i < FE_NLIMB; i++) {
        uint64_t two_p = (i == 0) ? 0x7ffffdaull : 2ull * FE_MASK(i);
        h[i] = (uint64_t)f.v[i] + two_p - g.v[i];
    }
    return fe_carry(h);
}

FE_FN fe fe_mul(const fe &f, const fe &g) {
    uint64_t h[FE_NLIMB];
    FE_UNROLL
    for (int k = 0; k < FE_NLIMB; k++) h[k] = 0;
    FE_UNROLL
    for (int i = 0; i < FE_NLIMB; i++) {
        FE_UNROLL
        for (int j = 0; j < FE_NLIMB; j++) {
            // bit offsets: o_i + o_j = o_{i+j} + 1 when i and j are odd
            uint32_t a = f.v[i] << (i & j & 1);
            uint32_t b = (i + j >= FE_NLIMB) ? 19u * g.v[j] : g.v[j];
            h[(i + j) % FE_NLIMB] += (uint64_t)a * b;
        }
    }
    return fe_carry(h);
}

FE_FN fe fe_sq(const fe &f) {
    uint64_t h[FE_NLIMB];
    FE_UNROLL
    for (int k = 0; k < FE_NLIMB; k++) h[k] = 0;
    FE_UNROLL
    for (int i = 0; i < FE_NLIMB; i++) {
        FE_UNROLL
        for (int j = i; j < FE_NLIMB; j++) {
            // cross terms count twice; odd x odd gains a bit, as in fe_mul
            uint32_t a = f.v[i] << ((i != j) + (i & j & 1));
            uint32_t b = (i + j >= FE_NLIMB) ? 19u * f.v[j] : f.v[j];
            h[(i + j) % FE_NLIMB] += (uint64_t)a * b;
        }
    }
    return fe_carry(h);
}

FE_FN fe fe_sqn(fe x, int n) {
    FE_NO_UNROLL
    for (int i = 0; i < n; i++) x = fe_sq(x);
    return x;
}

// z^(p-2): the curve25519 addition chain (254 squares + 11 multiplies),
// the same chain as field.py's fe_invert.  0 maps to 0.
FE_FN fe fe_invert(const fe &z) {
    fe z2 = fe_sq(z);
    fe z8 = fe_sqn(z2, 2);
    fe z9 = fe_mul(z, z8);
    fe z11 = fe_mul(z2, z9);
    fe z22 = fe_sq(z11);
    fe z_5_0 = fe_mul(z9, z22);
    fe z_10_0 = fe_mul(fe_sqn(z_5_0, 5), z_5_0);
    fe z_20_0 = fe_mul(fe_sqn(z_10_0, 10), z_10_0);
    fe z_40_0 = fe_mul(fe_sqn(z_20_0, 20), z_20_0);
    fe z_50_0 = fe_mul(fe_sqn(z_40_0, 10), z_10_0);
    fe z_100_0 = fe_mul(fe_sqn(z_50_0, 50), z_50_0);
    fe z_200_0 = fe_mul(fe_sqn(z_100_0, 100), z_100_0);
    fe z_250_0 = fe_mul(fe_sqn(z_200_0, 50), z_50_0);
    return fe_mul(fe_sqn(z_250_0, 5), z11);
}

// Fully reduced limbs (value in [0, p), every limb below its width).
FE_FN fe fe_canonical(const fe &f) {
    uint64_t h[FE_NLIMB];
    FE_UNROLL
    for (int i = 0; i < FE_NLIMB; i++) h[i] = f.v[i];
    // two passes with the fold: after the first, limbs 1..9 are below
    // their widths and limb 0 < 2^26 + 19; the second leaves every limb
    // below its width (a carry out of limb 0 happens only when the first
    // pass folded, and then limbs 1..9 are far from full)
    for (int pass = 0; pass < 2; pass++) {
        FE_UNROLL
        for (int i = 0; i < FE_NLIMB - 1; i++) {
            h[i + 1] += h[i] >> FE_WIDTH(i);
            h[i] &= FE_MASK(i);
        }
        h[0] += 19 * (h[9] >> 25);
        h[9] &= FE_MASK(9);
    }
    // value < 2^255 < 2p: subtract p iff value + 19 reaches 2^255
    uint64_t t[FE_NLIMB];
    t[0] = h[0] + 19;
    FE_UNROLL
    for (int i = 0; i < FE_NLIMB - 1; i++) {
        t[i + 1] = h[i + 1] + (t[i] >> FE_WIDTH(i));
        t[i] &= FE_MASK(i);
    }
    uint64_t ge_p = t[9] >> 25;
    t[9] &= FE_MASK(9);
    fe r;
    FE_UNROLL
    for (int i = 0; i < FE_NLIMB; i++) r.v[i] = (uint32_t)(ge_p ? t[i] : h[i]);
    return r;
}

// The 256-bit little-endian value in eight 32-bit words -> element (bit
// 255 ignored; a value in [p, 2^255) is a valid, non-canonical element).
// Limb i is bits [o_i, o_i + w_i) with o_i = ceil(25.5 i): it straddles at
// most two words.
FE_FN fe fe_fromwords(const uint32_t w[8]) {
    fe r;
    FE_UNROLL
    for (int i = 0; i < FE_NLIMB; i++) {
        int off = (51 * i + 1) / 2, q = off >> 5, sh = off & 31;
        uint64_t v = w[q] >> sh;
        if (q < 7) v |= (uint64_t)w[q + 1] << (32 - sh);
        r.v[i] = (uint32_t)v & FE_MASK(i);
    }
    return r;
}

// element -> its canonical value (bit 255 clear) in eight little-endian
// 32-bit words
FE_FN void fe_towords(uint32_t w[8], const fe &f) {
    fe c = fe_canonical(f);
    uint64_t acc = 0;
    int bits = 0, k = 0;
    FE_UNROLL
    for (int i = 0; i < FE_NLIMB; i++) {
        acc |= (uint64_t)c.v[i] << bits;   // bits < 32, so acc < 2^58
        bits += FE_WIDTH(i);
        if (bits >= 32) {
            w[k++] = (uint32_t)acc;
            acc >>= 32;
            bits -= 32;
        }
    }
    w[7] = (uint32_t)acc;   // the last 31 bits
}

// 32 little-endian bytes, any alignment -> element (as fe_fromwords)
FE_FN fe fe_frombytes(const uint8_t *s) {
    uint32_t w[8];
    FE_UNROLL
    for (int k = 0; k < 8; k++)
        w[k] = s[4 * k] | (uint32_t)s[4 * k + 1] << 8
             | (uint32_t)s[4 * k + 2] << 16 | (uint32_t)s[4 * k + 3] << 24;
    return fe_fromwords(w);
}

// element -> canonical 32 little-endian bytes, any alignment
FE_FN void fe_tobytes(uint8_t *s, const fe &f) {
    uint32_t w[8];
    fe_towords(w, f);
    FE_UNROLL
    for (int k = 0; k < 32; k++) s[k] = (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
}

// The same on 16-byte aligned rows (the resident tables): two 16-byte
// loads or stores instead of 32 byte-wide ones.  Both the card and the
// host are little-endian, so the words are the bytes' own.
FE_FN fe fe_load(const uint8_t *s) {
    uint32_t w[8];
#ifdef __CUDACC__
    uint4 a = reinterpret_cast<const uint4 *>(s)[0];
    uint4 b = reinterpret_cast<const uint4 *>(s)[1];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
#else
    memcpy(w, s, 32);
#endif
    return fe_fromwords(w);
}

FE_FN void fe_store(uint8_t *s, const fe &f) {
    uint32_t w[8];
    fe_towords(w, f);
#ifdef __CUDACC__
    reinterpret_cast<uint4 *>(s)[0] = make_uint4(w[0], w[1], w[2], w[3]);
    reinterpret_cast<uint4 *>(s)[1] = make_uint4(w[4], w[5], w[6], w[7]);
#else
    memcpy(s, w, 32);
#endif
}

FE_FN int fe_isodd(const fe &f) {
    return (int)(fe_canonical(f).v[0] & 1);
}
