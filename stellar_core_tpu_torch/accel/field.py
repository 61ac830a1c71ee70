"""GF(2^255-19) arithmetic on batches: the plain PyTorch version.

Counterpart of stellar_core_tpu/accel/field.py, kept in its layout for easy
comparison: little-endian 16 limbs x 16 bits in int64 tensors of shape
(..., 16), partially reduced in [0, 2^256) between ops and fully reduced only
by ``fe_canonical``.  The lazy-reduction bounds of that layout (fe_add and
fe_sub do not carry; fe_mul accepts limbs <= 2^22.2) are the reference's and
hold here unchanged, since the arithmetic is the same.

The CUDA kernels use their own layout (10 limbs of 25.5 bits, see
csrc/fe25519.cuh), which never leaves them: at their boundary every field
element is its canonical 32-byte encoding, which ``to_bytes`` / ``from_bytes``
carry to and from this layout.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _cuda_build

NLIMB = 16
RADIX = 16
MASK = (1 << RADIX) - 1

P = (1 << 255) - 19
_P_LIMBS = tuple((P >> (RADIX * i)) & MASK for i in range(NLIMB))
_BIAS64P = tuple(64 * l for l in _P_LIMBS)  # limbwise 64*p, value == 64p


def int_to_limbs(x: int) -> np.ndarray:
    return np.array([(x >> (RADIX * i)) & MASK for i in range(NLIMB)], dtype=np.int64)


def limbs_to_int(a) -> int:
    a = np.asarray(a)
    if a.shape != (NLIMB,):
        raise ValueError("limbs_to_int expects one element of 16 limbs")
    return sum(int(a[i]) << (RADIX * i) for i in range(NLIMB))


def ints_to_limbs(xs) -> np.ndarray:
    """Vector of python ints -> (n, 16) int64 limbs."""
    out = np.zeros((len(xs), NLIMB), dtype=np.int64)
    for j, x in enumerate(xs):
        for i in range(NLIMB):
            out[j, i] = (x >> (RADIX * i)) & MASK
    return out


def _carry_round(v):
    """One carry round: every limb sheds its carry to the next, limb 15's
    carry folds to limb 0 via 2^256 = 38 (mod p)."""
    c = v >> RADIX
    shifted = torch.cat([38 * c[..., NLIMB - 1:], c[..., :NLIMB - 1]], dim=-1)
    return (v & MASK) + shifted


def fe_carry(a):
    """Partially reduce with 3 carry rounds (limbs <= 2^16 + eps after)."""
    return _carry_round(_carry_round(_carry_round(a)))


def fe_add(a, b):
    """Lazy add: no carry (safe straight into fe_mul)."""
    return a + b


_consts: dict = {}   # device -> constant tensors of the plain field ops


def _const(device):
    """(64p bias, fold weights, fold columns, p limbs) on `device`."""
    c = _consts.get(device)
    if c is None:
        ij = np.add.outer(np.arange(NLIMB), np.arange(NLIMB))
        c = _consts[device] = tuple(
            torch.tensor(v, dtype=torch.int64, device=device) for v in (
                _BIAS64P, np.where(ij >= NLIMB, 38, 1),
                (ij % NLIMB).reshape(-1), _P_LIMBS))
    return c


def fe_sub(a, b):
    """Lazy subtract: adds a 64p limbwise bias so limbs stay non-negative;
    no carry (safe straight into fe_mul)."""
    return a + _const(a.device)[0] - b


def fe_mul(a, b):
    """16x16 schoolbook: product a_i*b_j lands at column i+j, and columns
    16..30 fold onto 0..14 by 38 (2^256 = 38 mod p).  With inputs <= 2^22.2
    a weighted product is <= 38 * 2^44.4 and a column of 16 < 2^54."""
    a, b = torch.broadcast_tensors(a, b)
    _, weight, column, _ = _const(a.device)
    rows = a[..., :, None] * b[..., None, :] * weight     # (..., 16, 16)
    out = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
    return fe_carry(out.index_add_(-1, column, rows.flatten(-2)))


def fe_square(a):
    return fe_mul(a, a)


def _nsquare(x, n: int):
    for _ in range(n):
        x = fe_mul(x, x)
    return x


def fe_invert(z):
    """z^(p-2) via the standard curve25519 addition chain (254 sq + 11 mul)."""
    z2 = fe_square(z)
    z8 = _nsquare(z2, 2)
    z9 = fe_mul(z, z8)
    z11 = fe_mul(z2, z9)
    z22 = fe_square(z11)
    z_5_0 = fe_mul(z9, z22)
    z_10_0 = fe_mul(_nsquare(z_5_0, 5), z_5_0)
    z_20_0 = fe_mul(_nsquare(z_10_0, 10), z_10_0)
    z_40_0 = fe_mul(_nsquare(z_20_0, 20), z_20_0)
    z_50_0 = fe_mul(_nsquare(z_40_0, 10), z_10_0)
    z_100_0 = fe_mul(_nsquare(z_50_0, 50), z_50_0)
    z_200_0 = fe_mul(_nsquare(z_100_0, 100), z_100_0)
    z_250_0 = fe_mul(_nsquare(z_200_0, 50), z_50_0)
    return fe_mul(_nsquare(z_250_0, 5), z11)


def fe_canonical(a):
    """Fully reduce to [0, p): exact carry normalization, then conditional
    subtract p twice with exact borrow."""
    p_limbs = _const(a.device)[3]

    def exact_pass(x):
        limbs = [x[..., i] for i in range(NLIMB)]
        carry = torch.zeros_like(limbs[0])
        for i in range(NLIMB):
            v = limbs[i] + carry
            limbs[i] = v & MASK
            carry = v >> RADIX
        limbs[0] = limbs[0] + 38 * carry
        return torch.stack(limbs, dim=-1)

    def cond_sub(x):
        # lexicographic x >= p, scanning from the top limb
        ge = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
        decided = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
        for i in range(NLIMB - 1, -1, -1):
            gt = x[..., i] > p_limbs[i]
            lt = x[..., i] < p_limbs[i]
            ge = torch.where(~decided & gt, True,
                             torch.where(~decided & lt, False, ge))
            decided = decided | gt | lt
        # subtract with borrow
        limbs = []
        borrow = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
        for i in range(NLIMB):
            v = x[..., i] - p_limbs[i] - borrow
            borrow = (v < 0).to(torch.int64)
            limbs.append(v + borrow * (1 << RADIX))
        sub = torch.stack(limbs, dim=-1)
        return torch.where(ge[..., None], sub, x)

    return cond_sub(cond_sub(exact_pass(exact_pass(fe_carry(a)))))


def fe_const(x: int, device) -> torch.Tensor:
    """Constant field element as a (16,) int64 tensor on `device`."""
    return torch.tensor(int_to_limbs(x % P), dtype=torch.int64, device=device)


def to_bytes(a) -> torch.Tensor:
    """(..., 16) limbs -> (..., 32) uint8 canonical little-endian encoding."""
    c = fe_canonical(a)
    lo = (c & 0xFF).to(torch.uint8)
    hi = ((c >> 8) & 0xFF).to(torch.uint8)
    return torch.stack([lo, hi], dim=-1).reshape(c.shape[:-1] + (32,))


def from_bytes(b) -> torch.Tensor:
    """(..., 32) uint8 little-endian -> (..., 16) int64 limbs (all 256 bits
    kept: a value in [p, 2^256) stays a valid partially reduced element)."""
    v = b.to(torch.int64).reshape(b.shape[:-1] + (NLIMB, 2))
    return v[..., 0] | (v[..., 1] << 8)


FE_CHECK_OPS = ("mul", "square", "add", "sub", "invert", "canonical", "chain")


def fe_check_plain(a, b, op: int):
    """The field-op check, plain version: op `FE_CHECK_OPS[op]` on the
    elements encoded in the (N, 32) uint8 rows a and b (bit 255 ignored);
    (N, 32) canonical encodings out.  "chain" is sixty rounds of
    a <- a*b - b."""
    a, b = a.clone(), b.clone()
    a[:, 31] &= 0x7F
    b[:, 31] &= 0x7F
    x, y = from_bytes(a), from_bytes(b)
    name = FE_CHECK_OPS[op]
    if name == "mul":
        r = fe_mul(x, y)
    elif name == "square":
        r = fe_square(x)
    elif name == "add":
        r = fe_add(x, y)
    elif name == "sub":
        r = fe_sub(x, y)
    elif name == "invert":
        r = fe_invert(x)
    elif name == "chain":
        r = x
        for _ in range(60):
            r = fe_sub(fe_mul(r, y), y)
    else:
        r = x
    return to_bytes(r)


_FE_CHECK = ("fe_check_launch",
             [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
              ctypes.c_void_p, ctypes.c_void_p])


def fe_check(a, b, op: int):
    """Wrapper of csrc/fe_check.cu, a check kernel (not a port of a TPU
    kernel): fe25519.cuh's op on the card, for holding against
    ``fe_check_plain``."""
    if a.device.type == "cpu":
        return fe_check_plain(a, b, op)
    n = a.shape[0]
    _cuda_build.check_tensors("fe_check", a.device, (a, torch.uint8, (n, 32)),
                              (b, torch.uint8, (n, 32)))
    if not 0 <= op < len(FE_CHECK_OPS):
        raise ValueError(f"unknown field op {op}")
    out = torch.empty((n, 32), dtype=torch.uint8, device=a.device)
    if n:
        _cuda_build.launch("fe_check", "fe_check", _FE_CHECK, a.device,
                           a.data_ptr(), b.data_ptr(), op, n, out.data_ptr())
        fe_check.launches += 1
    return out


fe_check.launches = 0
