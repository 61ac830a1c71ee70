"""Per-key precomputed window tables for Ed25519 verification (hot keys).

Counterpart of stellar_core_tpu/accel/tables.py.  For a key A (stored
negated, matching R = [s]B + [h](-A)) the table holds T[w][d] = d*16^w*(-A)
for the 64 4-bit windows of the scalar, in precomputed-add form
(Y-X, Y+X, 2d*T, 2Z).  Verification then needs no point doublings: 64 adds
from the base-point table for [s]B and 64 from the key's table for [h](-A).

Two kernels, each beside its plain version (csrc/tables.cu):

* **K-B** (``build_tables_into``) replaces ``tables.build_tables`` /
  ``_build_jit`` (stellar_core_tpu/accel/tables.py:51-106).  One thread per
  (key, window): thread w doubles A 4w times (the same doubling chain the
  reference's window scan runs, so every stored coordinate equals the
  reference's mod p), then emits the 16 multiples by 14 point adds.  Bound
  on the H100: integer multiply-adds (operations), about 1.07M per key
  for the build itself.  The design runs 5.9M: its threads double A
  8,064 times a key, 32x the 252 of a sequential chain, and the threads
  of low windows idle while window 63 runs its 252 doublings.  That buys
  parallelism across windows at the cost of redundant work, which matters
  only when many keys turn hot at once.
* **K-T** (``verify_tables``) replaces ``verify_tables_forward`` /
  ``_verify_tables_jit`` (:109-150).  One thread per signature walks the 64
  windows (two 8-multiply precomputed adds each), then encodes and compares
  with R.  Bound: integer multiply-adds, about 1.2e5 per signature; the
  entry reads (128 B each, 16 KiB per signature) hit L2, since 64 keys'
  tables (8 MiB) and the base table fit in its 50 MB.

The resident key table has one format on every device: (slots, 64, 16, 4,
32) uint8, each coordinate of an entry its canonical 32-byte encoding.  The
kernels keep their limb layout to themselves; the plain versions read the
same bytes with ``field.from_bytes``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _cuda_build
from ..device import upload
from . import field
from .curve import BX, BY, D2, PointBatch, point_add, point_dbl, point_encode

NWIN = 64          # 4-bit windows covering 256 bits
NDIG = 16          # digits per window
BUILD_K = 32       # keys per table-build launch


def _digits_le(raw, w):
    """Nibble w of a (N, 32) little-endian scalar byte matrix."""
    byte = raw[:, w // 2]
    return (byte >> (4 * (w % 2))) & 15


def build_tables(ax, ay):
    """(K,16)x2 affine int64 limbs -> (K, 64, 16, 4, 16) window tables:
    out[k, w, d] = d * 16^w * A_k in precomputed-add form
    (Y-X, Y+X, 2d*T, 2Z).  Digit 0 is the identity."""
    k = ax.shape[0]
    dev = ax.device
    d2 = field.fe_const(D2, dev)
    one = torch.zeros((k, field.NLIMB), dtype=torch.int64, device=dev)
    one[:, 0] = 1
    s = PointBatch(ax, ay, one, field.fe_mul(ax, ay))
    rows = []
    for _ in range(NWIN):
        # one window: multiples 0..15 of S, then carry 16*S forward
        mults = [PointBatch.identity((k,), dev), s]
        for _ in range(14):
            mults.append(point_add(mults[-1], s, d2))
        rows.append(torch.stack(
            [torch.stack(m.tree(), dim=1) for m in mults], dim=1))
        s = point_dbl(point_dbl(point_dbl(point_dbl(s))))
    rows = torch.stack(rows, dim=1)      # (K, 64, 16, 4, 16) as (X, Y, Z, T)
    ex, ey, ez, et = (rows[:, :, :, c] for c in range(4))
    return torch.stack([
        field.fe_sub(ey, ex),
        field.fe_add(ey, ex),
        field.fe_mul(et, d2),
        field.fe_add(ez, ez),
    ], dim=3)


def point_add_precomp(p: PointBatch, entry) -> PointBatch:
    """Add a precomputed table entry (y-x, y+x, 2d*t, 2z) to an extended
    point: 8 field mults."""
    em, ep, e2dt, e2z = entry[:, 0], entry[:, 1], entry[:, 2], entry[:, 3]
    A = field.fe_mul(field.fe_sub(p.Y, p.X), em)
    B = field.fe_mul(field.fe_add(p.Y, p.X), ep)
    C = field.fe_mul(p.T, e2dt)
    Dd = field.fe_mul(p.Z, e2z)
    E = field.fe_sub(B, A)
    F = field.fe_sub(Dd, C)
    G = field.fe_add(Dd, C)
    H = field.fe_add(B, A)
    return PointBatch(field.fe_mul(E, F), field.fe_mul(G, H),
                      field.fe_mul(F, G), field.fe_mul(E, H))


def verify_tables_forward(s_raw, h_raw, slots, r_bytes, key_table, base_table):
    """Table-path verify, plain version: R' = [s]B + [h](-A) by 64 steps of
    two precomputed-entry adds, then canonical encode + byte compare.
    s_raw/h_raw/r_bytes are (N, 32) uint8, slots (N,) int; the tables are
    (slots, 64, 16, 4, 32) and (64, 16, 4, 32) uint8 (see new_table).
    Returns (N,) bool."""
    s = s_raw.to(torch.int64)
    h = h_raw.to(torch.int64)
    slots = slots.long()
    r = PointBatch.identity((s.shape[0],), s.device)
    for w in range(NWIN):
        r = point_add_precomp(r, field.from_bytes(base_table[w, _digits_le(s, w)]))
        r = point_add_precomp(r, field.from_bytes(key_table[slots, w, _digits_le(h, w)]))
    enc = point_encode(r)
    return torch.all(enc == r_bytes, dim=-1)


def new_table(nslots: int, device) -> torch.Tensor:
    """Zeroed resident table: (nslots, 64, 16, 4, 32) uint8 on `device`."""
    return torch.zeros((nslots, NWIN, NDIG, 4, 32), dtype=torch.uint8,
                       device=device)


def _build_tables_into_plain(table, slots, key_xy):
    ax = field.from_bytes(key_xy[:, 0])
    ay = field.from_bytes(key_xy[:, 1])
    table[slots.long()] = field.to_bytes(build_tables(ax, ay))
    return table


def _check_aligned(what, *tables):
    """The kernels move table entries 16 bytes at a time."""
    for t in tables:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: a table is not 16-byte aligned")


_K_B = ("build_tables_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p])
_K_T = ("verify_tables_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p])


def build_tables_into(table, slots, key_xy):
    """K-B wrapper: build the window tables of K keys, given as canonical
    encodings of their affine (x, y) in `key_xy` (K, 2, 32) uint8, and
    write each one IN PLACE into its row `slots[k]` of the resident table
    (the reference scattered a new array; here the table is updated where
    it lives, so installing keys moves no other slot's bytes).  Returns
    `table`."""
    if table.device.type == "cpu":
        return _build_tables_into_plain(table, slots, key_xy)
    k = key_xy.shape[0]
    _cuda_build.check_tensors(
        "build_tables_into", table.device,
        (table, torch.uint8, (table.shape[0], NWIN, NDIG, 4, 32)),
        (slots, torch.int32, (k,)),
        (key_xy, torch.uint8, (k, 2, 32)))
    _check_aligned("build_tables_into", table)
    if k == 0:
        return table
    _cuda_build.launch("tables", "K-B", _K_B, table.device,
                       key_xy.data_ptr(), slots.data_ptr(), k,
                       table.data_ptr(), table.shape[0])
    build_tables_into.launches += 1
    return table


build_tables_into.launches = 0


def verify_tables(s_raw, h_raw, slots, r_bytes, key_table, base_table):
    """K-T wrapper: (N,) bool verdicts of the table path."""
    if s_raw.device.type == "cpu":
        return verify_tables_forward(s_raw, h_raw, slots, r_bytes, key_table,
                                     base_table)
    n = s_raw.shape[0]
    _cuda_build.check_tensors(
        "verify_tables", s_raw.device,
        (s_raw, torch.uint8, (n, 32)), (h_raw, torch.uint8, (n, 32)),
        (slots, torch.int32, (n,)), (r_bytes, torch.uint8, (n, 32)),
        (key_table, torch.uint8, (key_table.shape[0], NWIN, NDIG, 4, 32)),
        (base_table, torch.uint8, (NWIN, NDIG, 4, 32)))
    _check_aligned("verify_tables", key_table, base_table)
    out = torch.empty(n, dtype=torch.bool, device=s_raw.device)
    if n == 0:
        return out
    _cuda_build.launch("tables", "K-T", _K_T, s_raw.device,
                       s_raw.data_ptr(), h_raw.data_ptr(), r_bytes.data_ptr(),
                       slots.data_ptr(), n, key_table.data_ptr(),
                       key_table.shape[0], base_table.data_ptr(),
                       out.data_ptr())
    verify_tables.launches += 1
    return out


verify_tables.launches = 0


def base_xy() -> np.ndarray:
    """(1, 2, 32) canonical encodings of the base point's (x, y)."""
    return np.frombuffer(BX.to_bytes(32, "little") + BY.to_bytes(32, "little"),
                         dtype=np.uint8).reshape(1, 2, 32).copy()


_base_tables: dict = {}   # device -> (64, 16, 4, 32) base-point table


def base_point_table(device) -> torch.Tensor:
    """The base point B's (64, 16, 4, 32) uint8 table on `device`, built
    once per device (by K-B on CUDA)."""
    device = torch.device(device)
    tab = _base_tables.get(device)
    if tab is None:
        tab = build_tables_into(
            new_table(1, device),
            torch.zeros(1, dtype=torch.int32, device=device),
            torch.from_numpy(base_xy()).to(device))[0]
        _base_tables[device] = tab
    return tab


class KeyTableCache:
    """Device-resident per-key window tables with LRU slot reuse."""

    def __init__(self, slots: int = 192, *, device):
        self.nslots = slots
        self.device = torch.device(device)
        self.table = None           # see new_table for the format
        self.slot_of: dict = {}     # pk bytes -> slot
        self._tick = 0
        self._last_used: dict = {}  # pk bytes -> tick

    def _ensure(self):
        if self.table is None:
            self.table = new_table(self.nslots, self.device)

    def lookup(self, pk: bytes):
        slot = self.slot_of.get(pk)
        if slot is not None:
            self._tick += 1
            self._last_used[pk] = self._tick
        return slot

    def install(self, new_keys, protect=frozenset()):
        """new_keys: list of (pk_bytes, dec) where dec[0], dec[1] are the
        canonical 32-byte encodings of the affine (x, y) of -A (the pk
        cache's (3, 32) rows work as they are).  Builds tables in batches
        of BUILD_K and writes them into LRU slots.  Keys in `protect` (e.g.
        other keys used by the current batch) are never evicted.  Returns
        {pk: slot}; keys that could not get a slot (cache full of
        protected keys) are omitted."""
        if not new_keys:
            return {}
        self._ensure()
        # assign slots (evict least-recently-used unprotected keys); the
        # highest free slot goes first, as in the reference
        assigned = {}
        used = set(self.slot_of.values())
        free = [s for s in range(self.nslots) if s not in used]
        victims = sorted(
            (k for k in self.slot_of if k not in protect),
            key=lambda k: self._last_used.get(k, 0))
        kept = []
        for pk, dec in new_keys:
            if free:
                slot = free.pop()
            elif victims:
                victim = victims.pop(0)
                slot = self.slot_of.pop(victim)
                self._last_used.pop(victim, None)
            else:
                continue  # cache exhausted by protected keys
            assigned[pk] = slot
            self.slot_of[pk] = slot
            self._tick += 1
            self._last_used[pk] = self._tick
            kept.append((pk, dec))

        for start in range(0, len(kept), BUILD_K):
            batch = kept[start:start + BUILD_K]
            xy = np.stack([np.asarray(dec)[:2] for _, dec in batch])
            slots = np.array([assigned[pk] for pk, _ in batch], dtype=np.int32)
            build_tables_into(self.table, upload(slots, self.device),
                              upload(xy, self.device))
        return assigned
