// Edwards25519 point arithmetic over a quad: four adjacent lanes of a warp
// work one point, lane k holding its coordinate k (K-G, K-W, K-B); and
// over a pair of lanes, each holding a whole point (K-T, below).
//
// The complete a = -1 formulas of ge25519.cuh (ge_dbl, ge_add_pre, and the
// precomputed form) come as two stages of four independent products: doubling
// X^2, Y^2, Z^2, (X+Y)^2, then EF, GH, FG, EH; a precomputed add
// (Y-X)ymx, (Y+X)ypx, Z*2Z', T*2dT', then the same four.  That is the
// four-way parallel form of Hisil, Wong, Carter and Dawson, "Twisted
// Edwards Curves Revisited" (ASIACRYPT 2008, section 4).  Lane k computes
// product k of each stage with fe_mul / fe_sq of fe25519.cuh unchanged, and
// gets the operands it lacks from the other three lanes: a step of the
// verify chain is then 6 product latencies in a row instead of 24.  The
// formulas are the single-thread ones, so every coordinate agrees with
// ge25519.cuh's mod p.
//
// Lane layout.  A point: lane 0 X, lane 1 Y, lane 2 Z, lane 3 T.  A
// precomputed entry: lane 0 Y-X, lane 1 Y+X, lane 2 2Z, lane 3 2d*T (so a
// precomputed add's products Z*2Z' and T*2dT' use the lane's own
// coordinate).
//
// Exchange: __shfl_sync within the quad (width 4), one shuffle a limb.  A
// doubling gathers X and Y (2 elements) and the four products (4); a
// precomputed add swaps X and Y between lanes 0 and 1 (1) and gathers the
// four products: 170 shuffles a lane a step of the verify chain.  Shared
// memory was the alternative: a slot a quad, each lane storing its 10
// limbs and loading the three others' after a __syncwarp, 40 loads and
// stores where the four products take 40 shuffles, and 30 where X and Y
// take 20; both go through the same load/store unit, so the shuffles were
// kept.  Lane k's operands are chosen by per-limb selects (q_sel).  Every
// lane of the warp must reach every exchange: callers run whole warps and
// never return early.  On the H100, ptxas gives K-G and K-W 134 registers,
// no stack and no spills (PERF.md).
//
// The same source compiles as host C++ (no __CUDACC__), where a QFe holds
// all four lanes' values, each lane-wise operation loops over them and a
// gather is a copy, so the CPU tests run the very stage code the card runs.
#pragma once

#include "ge25519.cuh"

#ifdef __CUDACC__
// this lane's element
struct QFe {
    fe v;
};

FE_FN int q_lane() { return threadIdx.x & 3; }
FE_FN const fe &lv(const QFe &a, int) { return a.v; }
#define Q_LANEWISE(expr)              \
    QFe r;                            \
    {                                 \
        const int k = 0;              \
        r.v = (expr);                 \
        (void)k;                      \
    }                                 \
    return r;
#else
// the four lanes' elements
struct QFe {
    fe v[4];
};

FE_FN const fe &lv(const QFe &a, int k) { return a.v[k]; }
#define Q_LANEWISE(expr)                             \
    QFe r;                                           \
    for (int k = 0; k < 4; k++) r.v[k] = (expr);     \
    return r;
#endif

// a plain fe is the same value in every lane
FE_FN const fe &lv(const fe &a, int) { return a; }

template <class A, class B>
FE_FN QFe q_mul(const A &a, const B &b) { Q_LANEWISE(fe_mul(lv(a, k), lv(b, k))) }

template <class A>
FE_FN QFe q_sq(const A &a) { Q_LANEWISE(fe_sq(lv(a, k))) }

template <class A, class B>
FE_FN QFe q_add(const A &a, const B &b) { Q_LANEWISE(fe_add(lv(a, k), lv(b, k))) }

// Lane k takes a_k (each a plain fe or a QFe's lane-k value).
template <class A0, class A1, class A2, class A3>
FE_FN QFe q_sel(const A0 &a0, const A1 &a1, const A2 &a2, const A3 &a3) {
    QFe r;
#ifdef __CUDACC__
    const int k = q_lane();
    FE_UNROLL
    for (int l = 0; l < FE_NLIMB; l++) {
        uint32_t v = lv(a0, 0).v[l];
        v = k == 1 ? lv(a1, 0).v[l] : v;
        v = k == 2 ? lv(a2, 0).v[l] : v;
        v = k == 3 ? lv(a3, 0).v[l] : v;
        r.v.v[l] = v;
    }
#else
    r.v[0] = lv(a0, 0);
    r.v[1] = lv(a1, 1);
    r.v[2] = lv(a2, 2);
    r.v[3] = lv(a3, 3);
#endif
    return r;
}

// The element lane j of the quad holds, in every lane.
FE_FN fe q_get(const QFe &a, int j) {
#ifdef __CUDACC__
    fe r;
    FE_UNROLL
    for (int l = 0; l < FE_NLIMB; l++)
        r.v[l] = __shfl_sync(0xffffffffu, a.v.v[l], j, 4);
    return r;
#else
    return a.v[j];
#endif
}

// Sums and differences in 32-bit words, for the stage operands.  fe_add and
// fe_sub carry in uint64 columns; on the card a 64-bit shift or add is two
// instructions, and these operands never need the width: every limb here
// stays below 2^29.  fe_nc_add / fe_nc_sub leave the result uncarried
// (fe_nc_sub adds 2p limbwise, as fe_sub, so nothing is negative);
// fe_carry32 then carries exactly as fe_carry does, so the result is
// carried, and equal limb for limb to what fe_carry gives on the same sum.
FE_FN fe fe_nc_add(const fe &f, const fe &g) {
    fe r;
    FE_UNROLL
    for (int i = 0; i < FE_NLIMB; i++) r.v[i] = f.v[i] + g.v[i];
    return r;
}

FE_FN fe fe_nc_sub(const fe &f, const fe &g) {
    fe r;
    FE_UNROLL
    for (int i = 0; i < FE_NLIMB; i++)
        r.v[i] = f.v[i] + ((i == 0) ? 0x7ffffdau : 2u * FE_MASK(i)) - g.v[i];
    return r;
}

FE_FN fe fe_carry32(fe h) {
    FE_UNROLL
    for (int i = 0; i < FE_NLIMB - 1; i++) {
        h.v[i + 1] += h.v[i] >> FE_WIDTH(i);
        h.v[i] &= FE_MASK(i);
    }
    h.v[0] += 19 * (h.v[9] >> 25);
    h.v[9] &= FE_MASK(9);
    h.v[1] += h.v[0] >> 26;
    h.v[0] &= FE_MASK(0);
    return h;
}

template <class A, class B>
FE_FN QFe q_nc_add(const A &a, const B &b) { Q_LANEWISE(fe_nc_add(lv(a, k), lv(b, k))) }

template <class A, class B>
FE_FN QFe q_nc_sub(const A &a, const B &b) { Q_LANEWISE(fe_nc_sub(lv(a, k), lv(b, k))) }

FE_FN QFe q_carry(const QFe &a) { Q_LANEWISE(fe_carry32(lv(a, k))) }

// Lane k gets lane k ^ 1's element (lanes 0 and 1 swap, 2 and 3 swap).
FE_FN QFe q_swap1(const QFe &a) {
    QFe r;
#ifdef __CUDACC__
    FE_UNROLL
    for (int l = 0; l < FE_NLIMB; l++)
        r.v.v[l] = __shfl_xor_sync(0xffffffffu, a.v.v[l], 1, 4);
#else
    for (int k = 0; k < 4; k++) r.v[k] = a.v[k ^ 1];
#endif
    return r;
}

FE_FN QFe q_identity() { return q_sel(fe_zero(), fe_one(), fe_one(), fe_zero()); }

// The identity's precomputed entry (1, 1, 2, 0), which needs no product.
FE_FN QFe q_identity_pre() {
    fe two = fe_one();
    two.v[0] = 2;
    return q_sel(fe_one(), fe_one(), two, fe_zero());
}

// affine (x, y) with t = x*y given -> extended (x, y, 1, t)
FE_FN QFe q_from_affine(const fe &x, const fe &y, const fe &t) {
    return q_sel(x, y, fe_one(), t);
}

// (Y-X, Y+X, 2Z, 2d*T), the precomputed form of the plain build_tables
// (carried: the table's entries are a product's right operand, below)
FE_FN QFe q_to_pre(const QFe &p) {
    fe x = q_get(p, 0), y = q_get(p, 1);
    return q_sel(fe_sub(y, x), fe_add(y, x), q_add(p, p), q_mul(p, GE_D2));
}

// Bounds (fe25519.cuh's "carried": limbs < 2^26.01 even, < 2^25.01 odd).
// An uncarried sum of two carried elements has limbs < 2^27.01, a
// difference (with 2p) < 2^27.59.  fe_mul(f, g) shifts f by at most one
// bit and multiplies g by at most 19, each in a uint32: with f < 2^27.59
// and g carried a term is < 2^28.59 * 2^30.26, a column of ten < 2^62.2;
// fe_sq shifts f by at most 2 and multiplies by 19: with f < 2^27.01 a term
// is < 2^29.01 * 2^31.26, and a column has at most six, < 2^62.9.  Both
// stay inside the uint64 columns, so an uncarried sum or difference may be
// fe_mul's left operand against a carried right one, or fe_sq's operand.
// Every other operand is carried (q_carry).

// 2p, as ge_dbl.  Stage 1: A = X^2, B = Y^2, Z^2, (X+Y)^2 (lane 3's X+Y
// uncarried).  Stage 2: with H = A+B, G = A-B, C = 2Z^2, E = H - (X+Y)^2,
// F = C + G, lane k multiplies its two operands, (E, F), (G, H), (F, G),
// (E, H), each made as one sum of selected terms and one carry.
FE_FN QFe q_dbl(const QFe &p) {
    fe x = q_get(p, 0), y = q_get(p, 1);
    QFe s = q_sq(q_sel(p, p, p, fe_nc_add(x, y)));
    fe A = q_get(s, 0), B = q_get(s, 1), zz = q_get(s, 2), xy = q_get(s, 3);
    fe H = fe_nc_add(A, B);               // < 2^27.01
    fe G = fe_nc_sub(A, B);               // < 2^27.59
    fe C = fe_nc_add(zz, zz);             // < 2^27.01
    fe m = fe_nc_sub(fe_zero(), xy);      // -(X+Y)^2, < 2^27.01
    fe z = fe_zero();
    // E = H + m, G, F = G + C, E; then F, H, G, H: each sum < 2^28.3
    QFe left = q_carry(q_nc_add(q_sel(H, G, G, H), q_sel(m, z, C, m)));
    QFe right = q_carry(q_nc_add(q_sel(G, H, G, H), q_sel(C, z, z, z)));
    return q_mul(left, right);
}

// p + e, e precomputed (q_to_pre), as ge_add_pre.  Stage 1: lanes 0 and 1
// swap X and Y, lane 0 makes Y-X and lane 1 Y+X (uncarried, the left
// operands), and lane k multiplies by coordinate k of the entry: A =
// (Y-X)ymx, B = (Y+X)ypx, Dd = Z*2Z', C = T*2dT'.  Stage 2: with E = B-A,
// F = Dd-C, G = Dd+C, H = B+A, lane k multiplies (E, F), (G, H), (F, G) or
// (E, H), each carried once.  The full add p + q is q_add_pre(p,
// q_to_pre(q)): the same value as ge_add, whose products (T1 T2) 2d and
// 2 (Z1 Z2) it regroups as T1 (2d T2) and Z1 (2 Z2).
FE_FN QFe q_add_pre(const QFe &p, const QFe &e) {
    QFe o = q_swap1(p);                   // lane 0: Y, lane 1: X
    QFe m = q_mul(q_sel(q_nc_sub(o, p), q_nc_add(p, o), p, p), e);
    fe A = q_get(m, 0), B = q_get(m, 1), Dd = q_get(m, 2), C = q_get(m, 3);
    fe E = fe_nc_sub(B, A);
    fe F = fe_nc_sub(Dd, C);
    fe G = fe_nc_add(Dd, C);
    fe H = fe_nc_add(B, A);
    return q_mul(q_carry(q_sel(E, G, F, E)), q_carry(q_sel(F, H, G, H)));
}

// The canonical encoding of p (as ge_encode), in every lane: one fe_invert
// of Z (a serial chain; every lane runs it in step, which costs the warp no
// more issue slots than one lane alone), then lane 0 x = X/Z, lane 1
// y = Y/Z.
FE_FN void q_encode(uint8_t *s, const QFe &p) {
    fe zinv = fe_invert(q_get(p, 2));
    QFe xy = q_mul(p, zinv);
    fe x = q_get(xy, 0), y = q_get(xy, 1);
    fe_tobytes(s, y);
    s[31] |= (uint8_t)(fe_isodd(x) << 7);
}

// Where lane k's coordinate of a precomputed entry goes in the resident
// table's 128 bytes: the stored order is Y-X, Y+X, 2d*T, 2Z (ge25519.cuh),
// the quad's lanes hold Y-X, Y+X, 2Z, 2d*T.
#define Q_PRE_OFFSET(k) ((k) == 2 ? 96 : (k) == 3 ? 64 : 32 * (k))

// An entry e (q_to_pre) stored in that order: each lane the canonical bytes
// of its own coordinate.
FE_FN void q_pre_store(uint8_t *dst, const QFe &e) {
#ifdef __CUDACC__
    fe_store(dst + Q_PRE_OFFSET(q_lane()), e.v);
#else
    for (int k = 0; k < 4; k++) fe_store(dst + Q_PRE_OFFSET(k), e.v[k]);
#endif
}

// Whole points, one a lane of a pair (K-T): lanes 2j and 2j + 1 of a warp.
// Each lane runs the single-thread code of ge25519.cuh on a point of its
// own; the pair then joins the two.  A PGe is this lane's point on the card
// and the pair's two points on the host; in P_GE_LANEWISE, k is the lane's
// index in the pair (0 or 1) on both.
#ifdef __CUDACC__
struct PGe {
    ge v;
};

FE_FN int p_lane() { return threadIdx.x & 1; }
FE_FN const ge &pg(const PGe &a, int) { return a.v; }
#define P_GE_LANEWISE(expr)           \
    PGe r;                            \
    {                                 \
        const int k = p_lane();       \
        r.v = (expr);                 \
    }                                 \
    return r;

FE_FN fe fe_shfl_xor1(const fe &a) {
    fe r;
    FE_UNROLL
    for (int l = 0; l < FE_NLIMB; l++)
        r.v[l] = __shfl_xor_sync(0xffffffffu, a.v[l], 1, 2);
    return r;
}
#else
struct PGe {
    ge v[2];
};

FE_FN const ge &pg(const PGe &a, int k) { return a.v[k]; }
#define P_GE_LANEWISE(expr)                          \
    PGe r;                                           \
    for (int k = 0; k < 2; k++) r.v[k] = (expr);     \
    return r;
#endif

FE_FN PGe p_ge_add(const PGe &a, const PGe &b) { P_GE_LANEWISE(ge_add(pg(a, k), pg(b, k))) }

// Lane k gets the other lane's point: 40 shuffles.
FE_FN PGe p_ge_swap(const PGe &a) {
    PGe r;
#ifdef __CUDACC__
    r.v.X = fe_shfl_xor1(a.v.X);
    r.v.Y = fe_shfl_xor1(a.v.Y);
    r.v.Z = fe_shfl_xor1(a.v.Z);
    r.v.T = fe_shfl_xor1(a.v.T);
#else
    for (int k = 0; k < 2; k++) r.v[k] = a.v[k ^ 1];
#endif
    return r;
}

// The point of the pair's lane 0 (the lane that stores the pair's
// result); on the card every lane takes its own copy, which equals lane
// 0's mod p once the pair has joined its points.
FE_FN const ge &p_lane0(const PGe &a) {
#ifdef __CUDACC__
    return a.v;
#else
    return a.v[0];
#endif
}

// A quad's 16 precomputed entries, lane k keeping coordinate k of each
// (K-G, K-W), or K-B's 64 chain points.  On the card the table is shared
// memory laid out [entry][limb][thread]: thread t's limb l of entry e is
// p[(10 e + l) stride] with p = base + t, stride = the block's threads.  A
// warp's load of one limb is then 32 consecutive words whatever entry each
// quad takes: no bank conflict, and each thread reads only what it wrote
// itself, so no barrier is needed.  K-B's chain takes base + lane and
// stride 4 instead: every quad's lane k reads, after a barrier, what quad
// 0's lane k wrote.
#ifdef __CUDACC__
struct QTab {
    uint32_t *p;
    int stride;
};

FE_FN void q_tab_store(QTab &t, int e, const QFe &a) {
    FE_UNROLL
    for (int l = 0; l < FE_NLIMB; l++) t.p[(FE_NLIMB * e + l) * t.stride] = a.v.v[l];
}

FE_FN QFe q_tab_load(const QTab &t, int e) {
    QFe r;
    FE_UNROLL
    for (int l = 0; l < FE_NLIMB; l++) r.v.v[l] = t.p[(FE_NLIMB * e + l) * t.stride];
    return r;
}
#else
struct QTab {
    QFe e[64];   // K-B's chain; K-G's table uses the first 16
};

FE_FN void q_tab_store(QTab &t, int e, const QFe &a) { t.e[e] = a; }
FE_FN QFe q_tab_load(const QTab &t, int e) { return t.e[e]; }
#endif
