"""The port's plain GF(2^255-19) arithmetic against the JAX package's field
and python big-int ground truth (CPU, exact equality).

Mirrors the five tests of tests/test_accel_field.py, comparing canonical
values with stellar_core_tpu.accel.field on the same numpy-made inputs, and
adds randomized checks of the plain version's lazy-reduction bounds and of
the conversions to and from the canonical 32-byte encoding that the kernels
take at their boundary."""

import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from stellar_core_tpu_torch.accel import field as T

F = pytest.importorskip("stellar_core_tpu.accel.field")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")


def _port(xs):
    return torch.from_numpy(T.ints_to_limbs(xs))


def _ref(xs):
    return jnp.asarray(F.ints_to_limbs(xs))


def _ints(limbs):
    return [T.limbs_to_int(row) for row in np.asarray(limbs)]


def test_roundtrip_int_limbs():
    for x in (0, 1, 19, T.P - 1, 2 ** 255 - 20, 12345678901234567890):
        assert T.limbs_to_int(T.int_to_limbs(x)) == x
        assert np.array_equal(T.int_to_limbs(x), F.int_to_limbs(x))


def test_ops_match_bigint():
    rng = random.Random(7)
    xs = [rng.randrange(T.P) for _ in range(16)] + [0, 1, T.P - 1, (1 << 255) - 20]
    ys = [rng.randrange(T.P) for _ in range(len(xs))]
    px, py, rx, ry = _port(xs), _port(ys), _ref(xs), _ref(ys)
    for op, want in ((T.fe_mul, [x * y % T.P for x, y in zip(xs, ys)]),
                     (T.fe_add, [(x + y) % T.P for x, y in zip(xs, ys)]),
                     (T.fe_sub, [(x - y) % T.P for x, y in zip(xs, ys)])):
        got = T.fe_canonical(op(px, py))
        ref = np.asarray(F.fe_canonical(getattr(F, op.__name__)(rx, ry)))
        assert _ints(got) == want
        assert np.array_equal(got.numpy(), ref)


def test_invert():
    rng = random.Random(8)
    xs = [rng.randrange(1, T.P) for _ in range(8)] + [0]
    got = T.fe_canonical(T.fe_invert(_port(xs)))
    ref = np.asarray(jax.jit(lambda a: F.fe_canonical(F.fe_invert(a)))(_ref(xs)))
    assert np.array_equal(got.numpy(), ref)
    for x, inv in zip(xs[:-1], _ints(got)):
        assert inv * x % T.P == 1
    # 0^(p-2) = 0 (ref10's branchless inversion semantics)
    assert _ints(got)[-1] == 0


def test_long_chain_stays_exact():
    rng = random.Random(9)
    xs = [rng.randrange(T.P) for _ in range(4)]
    ys = [rng.randrange(T.P) for _ in range(4)]
    v, ay = _port(xs), _port(ys)
    rv, ray = _ref(xs), _ref(ys)
    acc = xs[:]
    for _ in range(60):
        v = T.fe_sub(T.fe_mul(v, ay), ay)
        rv = F.fe_sub(F.fe_mul(rv, ray), ray)
        acc = [(a * y - y) % T.P for a, y in zip(acc, ys)]
    got = T.fe_canonical(v)
    assert _ints(got) == acc
    assert np.array_equal(got.numpy(), np.asarray(F.fe_canonical(rv)))


def test_carry_invariant_bound():
    """After fe_carry, limbs stay below 2^16 + 2^10, as the reference's."""
    worst = np.full((4, T.NLIMB), 1 << 41, dtype=np.int64)
    out = T.fe_carry(torch.from_numpy(worst))
    assert int(out.max()) < (1 << 16) + (1 << 10)
    assert np.array_equal(out.numpy(), np.asarray(F.fe_carry(jnp.asarray(worst))))


_elem = st.integers(min_value=0, max_value=(1 << 256) - 1)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.lists(st.tuples(_elem, _elem), min_size=1, max_size=8))
def test_random_ops_from_any_256_bit_input(pairs):
    """Any 256-bit limb vector (values in [p, 2^256) included) is a valid
    input: mul/add/sub/square stay exact through canonicalization."""
    xs, ys = [p[0] for p in pairs], [p[1] for p in pairs]
    a, b = _port(xs), _port(ys)
    assert _ints(T.fe_canonical(T.fe_mul(a, b))) == [x * y % T.P for x, y in pairs]
    assert _ints(T.fe_canonical(T.fe_square(a))) == [x * x % T.P for x in xs]
    assert _ints(T.fe_canonical(T.fe_add(a, b))) == [(x + y) % T.P for x, y in pairs]
    assert _ints(T.fe_canonical(T.fe_sub(a, b))) == [(x - y) % T.P for x, y in pairs]


@settings(max_examples=30, deadline=None, derandomize=True)
@given(st.lists(st.tuples(_elem, _elem), min_size=1, max_size=4),
       st.integers(min_value=1, max_value=3))
def test_random_lazy_chains_stay_exact(pairs, depth):
    """Uncarried add/sub outputs fed straight into fe_mul, `depth` deep:
    the lazy-reduction bound (limbs <= 2^22.2 into fe_mul) holds."""
    xs, ys = [p[0] for p in pairs], [p[1] for p in pairs]
    v, b = _port(xs), _port(ys)
    acc = [x % T.P for x in xs]
    for _ in range(depth):
        v = T.fe_mul(T.fe_sub(T.fe_add(v, b), b), T.fe_add(b, b))
        acc = [a * 2 * y % T.P for a, y in zip(acc, ys)]
    assert _ints(T.fe_canonical(v)) == acc


@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.lists(_elem, min_size=1, max_size=8))
def test_bytes_and_kernel_layout_roundtrip(xs):
    a = _port(xs)
    enc = T.to_bytes(a)
    assert [int.from_bytes(r.numpy().tobytes(), "little") for r in enc] == \
        [x % T.P for x in xs]
    assert torch.equal(T.fe_canonical(T.from_bytes(enc)), T.fe_canonical(a))
    # any 32 bytes decode (the kernels' boundary format): the value's low
    # 256 bits, partially reduced
    raw = torch.from_numpy(np.array(
        [list((x % (1 << 256)).to_bytes(32, "little")) for x in xs], dtype=np.uint8))
    assert _ints(T.from_bytes(raw)) == [x % (1 << 256) for x in xs]
