"""Edwards25519 point arithmetic on batches (extended coordinates): the
plain PyTorch version.

Counterpart of stellar_core_tpu/accel/curve.py: the complete twisted-Edwards
a=-1 add/double formulas of RFC 8032 section 5.1.4, data-parallel over a
leading batch dimension.  The CUDA kernels' device functions for the same
formulas are csrc/ge25519.cuh.
"""

from __future__ import annotations

import torch

from .field import (NLIMB, P, fe_add, fe_canonical, fe_const, fe_invert,
                    fe_mul, fe_square, fe_sub)

# curve constants
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

# base point B
BY = (4 * pow(5, P - 2, P)) % P


def _recover_x(y: int, sign: int):
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if x == 0 and sign == 1:
        return None
    if x % 2 != sign:
        x = P - x
    return x


BX = _recover_x(BY, 0)
if BX is None:  # pragma: no cover - a constant of the curve
    raise AssertionError("base point y has no x")


class PointBatch:
    """Extended-coordinate points (X, Y, Z, T), each (..., 16) int64 limbs."""

    __slots__ = ("X", "Y", "Z", "T")

    def __init__(self, X, Y, Z, T):
        self.X, self.Y, self.Z, self.T = X, Y, Z, T

    @staticmethod
    def identity(shape, device):
        zero = torch.zeros(tuple(shape) + (NLIMB,), dtype=torch.int64,
                           device=device)
        one = zero.clone()
        one[..., 0] = 1
        return PointBatch(zero, one, one.clone(), zero.clone())

    def tree(self):
        return (self.X, self.Y, self.Z, self.T)


def point_dbl(p: PointBatch) -> PointBatch:
    A = fe_square(p.X)
    B = fe_square(p.Y)
    C = fe_add(fe_square(p.Z), fe_square(p.Z))
    H = fe_add(A, B)
    E = fe_sub(H, fe_square(fe_add(p.X, p.Y)))
    G = fe_sub(A, B)
    F = fe_add(C, G)
    return PointBatch(fe_mul(E, F), fe_mul(G, H), fe_mul(F, G), fe_mul(E, H))


def point_add(p: PointBatch, q: PointBatch, d2_limbs) -> PointBatch:
    A = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X))
    B = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X))
    C = fe_mul(fe_mul(p.T, q.T), d2_limbs)
    ZZ = fe_mul(p.Z, q.Z)
    Dd = fe_add(ZZ, ZZ)
    E = fe_sub(B, A)
    F = fe_sub(Dd, C)
    G = fe_add(Dd, C)
    H = fe_add(B, A)
    return PointBatch(fe_mul(E, F), fe_mul(G, H), fe_mul(F, G), fe_mul(E, H))


def _affine_mult(k: int):
    """k*B as exact affine ints (python, setup-time only)."""
    x, y = BX, BY
    rx, ry = 0, 1
    kk = k
    while kk:
        if kk & 1:
            nx = (rx * y + x * ry) * pow(1 + D * rx * x * ry * y, P - 2, P) % P
            ny = (ry * y + rx * x) * pow(1 - D * rx * x * ry * y, P - 2, P) % P
            rx, ry = nx, ny
        nx2 = (x * y + x * y) * pow(1 + D * x * x * y * y, P - 2, P) % P
        ny2 = (y * y + x * x) * pow(1 - D * x * x * y * y, P - 2, P) % P
        x, y = nx2, ny2
        kk >>= 1
    return rx, ry


_B_MULTS = [_affine_mult(k) for k in range(4)]  # 0B..3B (0B = identity)


def double_scalarmult_w2(windows, c_point: PointBatch):
    """R = [s]B + [h]C via joint 2-bit windows: per step R=4R; R+=T[w] where
    T[4i+j] = iB + jC (16-entry table built per batch).

    windows: (127, N) int tensor, w = 4*s_window + h_window, MSB-first
    (scalars < 2^254).
    """
    n = windows.shape[1]
    dev = c_point.X.device
    d2 = fe_const(D2, dev)

    def bcast(v):
        return v.expand(n, NLIMB)

    # C multiples: identity, C, 2C, 3C
    ident = PointBatch.identity((n,), dev)
    c2 = point_dbl(c_point)
    c3 = point_add(c2, c_point, d2)
    c_mults = [ident, c_point, c2, c3]

    entries = []
    for i in range(4):
        if i == 0:
            row = c_mults
        else:
            bx, by = _B_MULTS[i]
            bp = PointBatch(bcast(fe_const(bx, dev)), bcast(fe_const(by, dev)),
                            bcast(fe_const(1, dev)),
                            bcast(fe_const(bx * by % P, dev)))
            row = [bp] + [point_add(bp, c_mults[j], d2) for j in range(1, 4)]
        entries.extend(row)

    # (N, 16, NLIMB) per coordinate
    tab = [torch.stack([getattr(e, coord) for e in entries], dim=1)
           for coord in ("X", "Y", "Z", "T")]
    rows = torch.arange(n, device=dev)
    r = PointBatch.identity((n,), dev)
    for step in range(windows.shape[0]):
        r = point_dbl(point_dbl(r))
        w = windows[step].long()
        r = point_add(r, PointBatch(*(t[rows, w] for t in tab)), d2)
    return r


def point_encode(p: PointBatch):
    """Canonical 32-byte encoding as (N, 32) uint8: y LE with sign(x) in bit 255."""
    zinv = fe_invert(p.Z)
    x = fe_canonical(fe_mul(p.X, zinv))
    y = fe_canonical(fe_mul(p.Y, zinv))
    y = y.clone()
    y[..., NLIMB - 1] += (x[..., 0] & 1) << 15
    lo = (y & 0xFF).to(torch.uint8)
    hi = ((y >> 8) & 0xFF).to(torch.uint8)
    return torch.stack([lo, hi], dim=-1).reshape(y.shape[:-1] + (32,))
