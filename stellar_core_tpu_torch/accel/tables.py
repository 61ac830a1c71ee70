"""Per-key precomputed window tables for Ed25519 verification (hot keys).

Counterpart of stellar_core_tpu/accel/tables.py.  For a key A (stored
negated, matching R = [s]B + [h](-A)) the table holds T[w][d] = d*16^w*(-A)
for the 64 4-bit windows of the scalar, in precomputed-add form
(Y-X, Y+X, 2d*T, 2Z).  Verification then needs no point doublings: 64 adds
from the base-point table for [s]B and 64 from the key's table for [h](-A).

Two kernels, each beside its plain version (csrc/tables.cu), K-B on quads
of four lanes, K-T on pairs (csrc/ge25519_quad.cuh):

* **K-B** (``build_tables_into``) replaces ``tables.build_tables`` /
  ``_build_jit`` (stellar_core_tpu/accel/tables.py:51-106).  A block a
  key: one warp runs the key's doubling chain once (252 doublings with the
  quad's q_dbl: the reference's window scan, so every stored coordinate
  equals the reference's mod p) into shared memory, then quad w makes
  window w's 16 entries by 14 adds of 16^w A, each lane storing one
  coordinate.  Bound on the H100: integer multiply-adds (operations),
  about 1.07M a key for the build; but the chain's 252 doublings run one
  after another, so a launch takes at least 252 latencies of one doubling
  (the chain floor, which chip_smoke.py measures with ``dbl_chain``).  The
  old design, a thread a (key, window), ran the chain 32 times over.
* **K-T** (``verify_tables``) replaces ``verify_tables_forward`` /
  ``_verify_tables_jit`` (:109-150).  A pair of lanes a signature: lane k
  adds the entries of the windows w = k (mod 2) (64 precomputed adds), one
  shuffle round and a complete add join the two halves, and each lane
  encodes its copy and compares with R.  Bound: integer multiply-adds,
  about 1.2e5 a signature; the entry reads (128 B each, 16 KiB a
  signature) hit L2, since 64 keys' tables (8 MiB) and the base table fit
  in its 50 MB.  A pair a signature gives the hot chunk twice the warps of
  one thread a signature, which waited on each add's chain of dependent
  products; four lanes a signature lost on the card (PERF.md).

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
from ..device import on_device, upload
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
    return _precomputed(*(rows[:, :, :, c] for c in range(4)), d2, dim=3)


def _precomputed(X, Y, Z, T, d2, dim):
    """(Y-X, Y+X, 2d*T, 2Z) stacked along `dim`."""
    return torch.stack([field.fe_sub(Y, X), field.fe_add(Y, X),
                        field.fe_mul(T, d2), field.fe_add(Z, Z)], dim=dim)


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


def dbl_chain_plain(key_xy, steps: int):
    """`steps` doublings of each point with affine encodings `key_xy`
    (K, 2, 32) uint8: (K, 4, 32) uint8, the canonical bytes of the result's
    precomputed form, in a table entry's order."""
    ax = field.from_bytes(key_xy[:, 0])
    ay = field.from_bytes(key_xy[:, 1])
    one = torch.zeros_like(ax)
    one[:, 0] = 1
    p = PointBatch(ax, ay, one, field.fe_mul(ax, ay))
    for _ in range(steps):
        p = point_dbl(p)
    d2 = field.fe_const(D2, key_xy.device)
    return field.to_bytes(_precomputed(p.X, p.Y, p.Z, p.T, d2, dim=1))


_DBL_CHAIN = ("dbl_chain_launch",
              [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
               ctypes.c_void_p, ctypes.c_void_p])


def dbl_chain(key_xy, steps: int):
    """Wrapper of the check kernel dbl_chain (csrc/fe_check.cu; not a port
    of a TPU kernel): ``dbl_chain_plain`` on the card, each point's chain
    on a quad of lanes with K-B's doubling.  On one point it is one warp's
    chain of ``steps`` doublings: chip_smoke.py times it for K-B's chain
    floor."""
    if key_xy.device.type == "cpu":
        return dbl_chain_plain(key_xy, steps)
    k = key_xy.shape[0]
    _cuda_build.check_tensors("dbl_chain", key_xy.device,
                              (key_xy, torch.uint8, (k, 2, 32)))
    if steps < 0:
        raise ValueError(f"dbl_chain: steps {steps} < 0")
    out = torch.empty((k, 4, 32), dtype=torch.uint8, device=key_xy.device)
    if k:
        _cuda_build.launch("fe_check", "dbl_chain", _DBL_CHAIN, key_xy.device,
                           key_xy.data_ptr(), k, steps, out.data_ptr())
        dbl_chain.launches += 1
    return out


dbl_chain.launches = 0


def base_xy() -> np.ndarray:
    """(1, 2, 32) canonical encodings of the base point's (x, y)."""
    return np.frombuffer(BX.to_bytes(32, "little") + BY.to_bytes(32, "little"),
                         dtype=np.uint8).reshape(1, 2, 32).copy()


_base_tables: dict = {}   # device -> (64, 16, 4, 32) base-point table


def base_point_table(device) -> torch.Tensor:
    """The base point B's (64, 16, 4, 32) uint8 table on `device`, built
    once per device (by K-B on CUDA, on the device's current stream)."""
    device = torch.device(device)
    tab = _base_tables.get(device)
    if tab is None:
        with on_device(device):
            tab = build_tables_into(
                new_table(1, device),
                torch.zeros(1, dtype=torch.int32, device=device),
                torch.from_numpy(base_xy()).to(device))[0]
        _base_tables[device] = tab
    return tab


class KeyTableCache:
    """Device-resident per-key window tables with LRU slot reuse.

    `mirrors`: further devices that hold a replica of every table, for the
    sharded verifier.  The slot map and LRU ticks are one; each device has
    its own table tensor, and K-B builds each replica on its own device from
    the same key bytes (so no copy crosses between cards, and every replica
    is the bytes the first device holds)."""

    def __init__(self, slots: int = 192, *, device, mirrors=()):
        self.nslots = slots
        self.device = torch.device(device)
        self.mirrors = tuple(d for d in dict.fromkeys(map(torch.device, mirrors))
                             if d != self.device)
        self.table = None           # see new_table for the format
        self.mirror_tables: dict = {}   # mirror device -> its table
        self.slot_of: dict = {}     # pk bytes -> slot
        self._tick = 0
        self._last_used: dict = {}  # pk bytes -> tick
        self._readers: list = []    # events after launches that read them

    def _ensure(self):
        if self.table is None:
            self.table = new_table(self.nslots, self.device)
            self.mirror_tables = {d: new_table(self.nslots, d)
                                  for d in self.mirrors}

    def table_on(self, device) -> torch.Tensor:
        """The resident table on `device` (this cache's or a mirror)."""
        device = torch.device(device)
        return self.table if device == self.device else self.mirror_tables[device]

    def note_readers(self, events) -> None:
        """Record `events` (CUDA events, None on the CPU), each recorded
        after launches that read the tables; install's rewrites wait for
        them, on whatever stream those launches ran."""
        self._readers = [e for e in self._readers if not e.query()] \
            + [e for e in events if e is not None]

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

        # a slot is rewritten in place: earlier launches that read it
        # finish first
        for dev in (self.device,) + self.mirrors:
            if dev.type == "cuda":
                for event in self._readers:
                    torch.cuda.current_stream(dev).wait_event(event)
        self._readers = []
        for start in range(0, len(kept), BUILD_K):
            batch = kept[start:start + BUILD_K]
            xy = np.stack([np.asarray(dec)[:2] for _, dec in batch])
            slots = np.array([assigned[pk] for pk, _ in batch], dtype=np.int32)
            for dev in (self.device,) + self.mirrors:
                with on_device(dev):
                    build_tables_into(self.table_on(dev), upload(slots, dev),
                                      upload(xy, dev))
        return assigned
