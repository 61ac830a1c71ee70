"""The port's plain Edwards25519 point arithmetic against the JAX package's
accel/curve.py on the same numpy-made inputs (CPU, exact equality)."""

import random

import numpy as np
import pytest
import torch

from stellar_core_tpu_torch.accel import curve as T
from stellar_core_tpu_torch.accel import field as TF
from stellar_core_tpu_torch.accel.ed25519 import (_edwards_add_affine,
                                                  _scalar_mul_affine)

C = pytest.importorskip("stellar_core_tpu.accel.curve")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

P = TF.P


def _points(n, seed):
    """n random multiples of B in extended coordinates, each scaled by a
    random Z, as (4, n, 16) int64 limbs (X, Y, Z, T)."""
    rng = random.Random(seed)
    rows = []
    for _ in range(n):
        x, y = T._affine_mult(rng.randrange(1, 1 << 24))
        z = rng.randrange(1, P)
        rows.append([x * z % P, y * z % P, z, x * y * z % P])
    return np.stack([TF.ints_to_limbs([r[c] for r in rows]) for c in range(4)])


def _port(a):
    return T.PointBatch(*(torch.from_numpy(a[c]) for c in range(4)))


def _ref(a):
    return C.PointBatch(*(jnp.asarray(a[c]) for c in range(4)))


_ref_encode = jax.jit(lambda *t: C.point_encode(C.PointBatch(*t)))
N = 6   # one batch width, so the reference's encode compiles once


def _same(port_pt, ref_pt):
    """Projective coordinates equal as canonical values, and the encoded
    points equal."""
    for p, r in zip(port_pt.tree(), ref_pt.tree()):
        assert np.array_equal(TF.fe_canonical(p).numpy(),
                              np.asarray(C.fe_canonical(r)))
    assert np.array_equal(T.point_encode(port_pt).numpy(),
                          np.asarray(_ref_encode(*ref_pt.tree())))


def _affine_encode(x, y):
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def test_constants_match():
    assert (T.D, T.D2, T.SQRT_M1, T.BX, T.BY) == (C.D, C.D2, C.SQRT_M1, C.BX, C.BY)
    assert T._B_MULTS == C._B_MULTS
    for y in (2, 3, 4, T.BY, P - 1):
        for sign in (0, 1):
            assert T._recover_x(y, sign) == C._recover_x(y, sign)


def test_point_dbl_and_add_match_reference():
    a, b = _points(N, 1), _points(N, 2)
    _same(T.point_dbl(_port(a)), C.point_dbl(_ref(a)))
    _same(T.point_add(_port(a), _port(b), TF.fe_const(T.D2, "cpu")),
          C.point_add(_ref(a), _ref(b), C.fe_const(C.D2)))
    # adding a point to itself (the formulas are complete)
    _same(T.point_add(_port(a), _port(a), TF.fe_const(T.D2, "cpu")),
          C.point_add(_ref(a), _ref(a), C.fe_const(C.D2)))


def test_point_encode_matches_reference_and_affine():
    rng = random.Random(3)
    ks = [rng.randrange(1, 1 << 24) for _ in range(N)]
    rows = []
    for k in ks:
        x, y = T._affine_mult(k)
        z = rng.randrange(1, P)
        rows.append([x * z % P, y * z % P, z, x * y * z % P])
    a = np.stack([TF.ints_to_limbs([r[c] for r in rows]) for c in range(4)])
    got = T.point_encode(_port(a)).numpy()
    ref = np.asarray(_ref_encode(*(jnp.asarray(a[c]) for c in range(4))))
    assert np.array_equal(got, ref)
    assert [bytes(r) for r in got] == [_affine_encode(*T._affine_mult(k)) for k in ks]


def test_double_scalarmult_w2_matches_reference():
    """R = [s]B + [h]C over four joint windows (scalars < 2^8): the
    reference runs without jit (its scan as a python loop, so nothing is
    compiled); the 127-window length is held against the reference through
    the verify paths in test_torch_ed25519.py."""
    rng = np.random.default_rng(4)
    n, nwin = N, 4
    windows = rng.integers(0, 16, size=(nwin, n)).astype(np.int32)
    c_pts = _points(n, 5)
    got = T.double_scalarmult_w2(torch.from_numpy(windows), _port(c_pts))
    with jax.disable_jit():
        ref = C.double_scalarmult_w2(jnp.asarray(windows), _ref(c_pts))
    enc = T.point_encode(got).numpy()
    assert np.array_equal(enc, T.point_encode(T.PointBatch(
        *(torch.from_numpy(np.array(v)) for v in ref.tree()))).numpy())
    # and against python ints: s, h from the windows, C from its limbs
    for i in range(n):
        s = h = 0
        for w in windows[:, i]:
            s, h = 4 * s + int(w) // 4, 4 * h + int(w) % 4
        z = TF.limbs_to_int(c_pts[2, i])
        zinv = pow(z, P - 2, P)
        cx, cy = (TF.limbs_to_int(c_pts[0, i]) * zinv % P,
                  TF.limbs_to_int(c_pts[1, i]) * zinv % P)
        want = _edwards_add_affine(_scalar_mul_affine(s, (T.BX, T.BY)),
                                   _scalar_mul_affine(h, (cx, cy)))
        assert bytes(enc[i]) == _affine_encode(*want)
