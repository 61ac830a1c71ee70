"""Batched Ed25519 verification on CUDA: the port of the TPUCryptoBackend.

Counterpart of stellar_core_tpu/accel/ed25519.py.  Split of labor:

- host (numpy / python ints, exact, copied from the reference): the
  per-signature encoding checks in libsodium's order -- S canonical (< L),
  R not small-order, pk canonical and not small-order, pk decompression --
  plus the SHA-512 challenge h = SHA512(R || pk || msg) mod L and the
  hot/cold key split;
- device: cold keys through kernel K-G (``verify_generic``, below), hot
  keys through the per-key tables of kernels K-B and K-T (tables.py).  With
  several devices each chunk is split into contiguous parts, one a device,
  and the key rows and tables are replicated (the reference's
  ``_sharded_generic`` / ``_sharded_tables``, ed25519.py:200-227).

Verdict contract: bit-identical accept/reject with libsodium
``crypto_sign_verify_detached`` and with the JAX package's ``verify_batch``.

**K-G** (csrc/verify_generic.cu) replaces ``verify_forward_raw`` /
``_verify_kernel_raw`` (stellar_core_tpu/accel/ed25519.py:157-184) and the
``double_scalarmult_w2`` / ``point_encode`` it runs (curve.py:125-184).
A quad of four lanes per signature reads the raw s, h and R bytes and a key
index, derives the 127 joint 2-bit windows itself, builds the 16-entry
iB + jC table in shared memory (lane k keeps coordinate k of each entry),
runs R <- 4R + T[w] with each lane computing one of the four independent
products of a stage (csrc/ge25519_quad.cuh), encodes and compares.  Bound
on the H100: integer multiply-adds (operations), about 2.8e5 per
signature; it moves 97 bytes per signature.

**K-W** (csrc/verify_generic.cu, ``verify_windows``) replaces
``verify_forward`` / ``_verify_kernel`` (stellar_core_tpu/accel/ed25519.py:
142-154), the graft entry's step: the same body as K-G (verify.cuh's
``verify_joint_quad``), with the (127, N) windows given by the caller, and
an optional fused accept count (lane 0 of each quad votes).
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import _cuda_build
from ..device import Shards, parts, resolve_shards, upload
from ..util import tracing
from ..util.lockorder import make_lock
from ..util.metrics import registry as _registry
from . import field, tables as _tables
from .curve import D, P, PointBatch, SQRT_M1, _recover_x, double_scalarmult_w2, point_encode

L = (1 << 252) + 27742317777372353535851937790883648493

_PK_UNSEEN = object()  # cache sentinel: distinguishes "never seen" from "rejected"


def _edwards_add_affine(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    x3 = (x1 * y2 + x2 * y1) * pow(1 + D * x1 * x2 * y1 * y2, P - 2, P) % P
    y3 = (y1 * y2 + x1 * x2) * pow(1 - D * x1 * x2 * y1 * y2, P - 2, P) % P
    return (x3, y3)


def _scalar_mul_affine(k, pt):
    r = (0, 1)
    q = pt
    while k:
        if k & 1:
            r = _edwards_add_affine(r, q)
        q = _edwards_add_affine(q, q)
        k >>= 1
    return r


def _derive_order8_ys() -> Tuple[int, int]:
    """The two order-8 torsion y-coordinates, derived (not hardcoded):
    an order-8 point R doubles to an order-4 point (+-sqrt(-1), 0); working
    through the doubling formula with Y3=0 and the curve equation gives
    d*y^4 + 2*y^2 - 1 = 0, i.e. y^2 = (-1 +- sqrt(1+d))/d (mod p)."""
    sq = pow(1 + D, (P + 3) // 8, P)
    if (sq * sq - (1 + D)) % P != 0:
        sq = sq * SQRT_M1 % P
    if (sq * sq - (1 + D)) % P != 0:  # pragma: no cover - a curve constant
        raise AssertionError("1 + d has no square root")
    ys = []
    for root in (sq, P - sq):
        y2 = (root - 1) * pow(D, P - 2, P) % P
        y = pow(y2, (P + 3) // 8, P)
        if (y * y - y2) % P != 0:
            y = y * SQRT_M1 % P
        if (y * y - y2) % P != 0:
            continue
        for yy in (y, P - y):
            x = _recover_x(yy, 0)
            if x is None:
                continue
            pt = (x, yy)
            if (_scalar_mul_affine(8, pt) == (0, 1)
                    and _scalar_mul_affine(4, pt) != (0, 1)):
                ys.append(yy)
    ys = sorted(set(ys))
    if len(ys) != 2:  # pragma: no cover - a curve constant
        raise AssertionError(f"expected 2 order-8 y values, got {ys}")
    return ys[0], ys[1]


_Y8A, _Y8B = _derive_order8_ys()

_BLOCKLIST = np.stack([
    np.frombuffer((0).to_bytes(32, "little"), dtype=np.uint8),
    np.frombuffer((1).to_bytes(32, "little"), dtype=np.uint8),
    np.frombuffer(_Y8A.to_bytes(32, "little"), dtype=np.uint8),
    np.frombuffer(_Y8B.to_bytes(32, "little"), dtype=np.uint8),
    np.frombuffer((P - 1).to_bytes(32, "little"), dtype=np.uint8),
    np.frombuffer(P.to_bytes(32, "little"), dtype=np.uint8),
    np.frombuffer((P + 1).to_bytes(32, "little"), dtype=np.uint8),
])


_BLOCKLIST_MASKED = _BLOCKLIST.copy()
_BLOCKLIST_MASKED[:, 31] &= 0x7F

_P_BYTES = np.frombuffer(P.to_bytes(32, "little"), dtype=np.uint8)
_L_BYTES = np.frombuffer(L.to_bytes(32, "little"), dtype=np.uint8)


def _lt_vec(a: np.ndarray, bound: np.ndarray) -> np.ndarray:
    """(N, 32) LE byte matrix < bound (32 LE bytes), vectorized lexicographic
    compare from the most-significant byte down."""
    lt = np.zeros(a.shape[0], dtype=bool)
    decided = np.zeros(a.shape[0], dtype=bool)
    for i in range(31, -1, -1):
        bi = int(bound[i])
        lt |= (~decided) & (a[:, i] < bi)
        decided |= a[:, i] != bi
    return lt


def _small_order_vec(a: np.ndarray) -> np.ndarray:
    """(N, 32) encodings -> bool mask of small-order points (sign masked)."""
    m = a.copy()
    m[:, 31] &= 0x7F
    return np.any(np.all(m[:, None, :] == _BLOCKLIST_MASKED[None, :, :], axis=2),
                  axis=1)


def _windows_msb_first(s_raw: np.ndarray, h_raw: np.ndarray) -> np.ndarray:
    """(N, 32) LE scalar bytes x2 -> (127, N) int32 joint 2-bit windows,
    w = 4*s_window + h_window, MSB first (scalars < 2^253 < 2^254)."""
    sb = np.unpackbits(s_raw, axis=1, bitorder="little")
    hb = np.unpackbits(h_raw, axis=1, bitorder="little")
    s2 = sb[:, 0:254:2] + 2 * sb[:, 1:254:2]
    h2 = hb[:, 0:254:2] + 2 * hb[:, 1:254:2]
    w = (4 * s2 + h2).astype(np.int32)
    return w[:, ::-1].T.copy()


def verify_forward(windows, cx, cy, ct, r_bytes):
    """Windowed double-scalarmult + canonical encode + byte-compare, plain
    version (cx/cy/ct: (N, 16) limbs of -A)."""
    n = cx.shape[0]
    cz = torch.zeros((n, field.NLIMB), dtype=torch.int64, device=cx.device)
    cz[:, 0] = 1
    r = double_scalarmult_w2(windows, PointBatch(cx, cy, cz, ct))
    return torch.all(point_encode(r) == r_bytes, dim=-1)


def _windows(s_raw, h_raw):
    """(N, 32) uint8 LE scalar bytes x2 -> (127, N) joint 2-bit windows,
    w = 4*s_window + h_window, MSB first."""
    s = s_raw.to(torch.int64)
    h = h_raw.to(torch.int64)
    j = torch.arange(127, device=s.device)
    byte_idx = j // 4
    shift = (2 * j) % 8
    s2 = (s[:, byte_idx] >> shift) & 3       # (N, 127)
    h2 = (h[:, byte_idx] >> shift) & 3
    w = 4 * s2 + h2
    return w.flip(1).T


def verify_forward_raw(s_raw, h_raw, key_idx, keys, r_bytes):
    """Generic path, plain version: raw scalar bytes + a per-signature index
    into de-duplicated key rows `keys` (nk, 3, 32) uint8, the canonical
    encodings of (x, y, t) of -A.  Returns (N,) bool."""
    rows = keys[key_idx.long()]
    cx, cy, ct = (field.from_bytes(rows[:, c]) for c in range(3))
    return verify_forward(_windows(s_raw, h_raw), cx, cy, ct, r_bytes)


_K_G = ("verify_generic_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
         ctypes.c_void_p])


NWINDOWS = 127


def verify_windows_plain(windows, keys, r_bytes):
    """The windows form, plain version: ``verify_forward`` fed by the key
    rows (N, 3, 32) uint8, the canonical encodings of (x, y, t) of -A.  A
    window outside [0, 16) is outside the contract and raises."""
    if windows.numel() and (int(windows.min()) < 0 or int(windows.max()) > 15):
        raise ValueError("verify_windows: a window outside [0, 16)")
    cx, cy, ct = (field.from_bytes(keys[:, c]) for c in range(3))
    return verify_forward(windows, cx, cy, ct, r_bytes)


_K_W = ("verify_windows_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


def verify_windows(windows, keys, r_bytes, count=None):
    """K-W wrapper: (N,) bool verdicts of (127, N) int32 windows, MSB
    first, (N, 3, 32) uint8 key rows of -A and (N, 32) uint8 R bytes.  With
    `count`, a (1,) int32 tensor, the number accepted is added to count[0]
    (on the card by the kernel, a warp at a time)."""
    if windows.device.type == "cpu":
        ok = verify_windows_plain(windows, keys, r_bytes)
        if count is not None:
            count += ok.sum(dtype=torch.int32)
        return ok
    n = windows.shape[-1]
    _cuda_build.check_tensors(
        "verify_windows", windows.device,
        (windows, torch.int32, (NWINDOWS, n)), (keys, torch.uint8, (n, 3, 32)),
        (r_bytes, torch.uint8, (n, 32)),
        *([(count, torch.int32, (1,))] if count is not None else []))
    out = torch.empty(n, dtype=torch.bool, device=windows.device)
    if n == 0:
        return out
    _cuda_build.launch("verify_generic", "K-W", _K_W, windows.device,
                       windows.data_ptr(), keys.data_ptr(), r_bytes.data_ptr(),
                       n, out.data_ptr(),
                       None if count is None else count.data_ptr())
    verify_windows.launches += 1
    return out


verify_windows.launches = 0


def verify_generic(s_raw, h_raw, key_idx, keys, r_bytes):
    """K-G wrapper: (N,) bool verdicts of the generic path.  The kernel
    reads only the N signature rows and nk key rows it is given."""
    if s_raw.device.type == "cpu":
        return verify_forward_raw(s_raw, h_raw, key_idx, keys, r_bytes)
    n, nk = s_raw.shape[0], keys.shape[0]
    _cuda_build.check_tensors(
        "verify_generic", s_raw.device,
        (s_raw, torch.uint8, (n, 32)), (h_raw, torch.uint8, (n, 32)),
        (key_idx, torch.int32, (n,)), (keys, torch.uint8, (nk, 3, 32)),
        (r_bytes, torch.uint8, (n, 32)))
    out = torch.empty(n, dtype=torch.bool, device=s_raw.device)
    if n == 0:
        return out
    _cuda_build.launch("verify_generic", "K-G", _K_G, s_raw.device,
                       s_raw.data_ptr(), h_raw.data_ptr(), r_bytes.data_ptr(),
                       key_idx.data_ptr(), n, keys.data_ptr(), nk,
                       out.data_ptr())
    verify_generic.launches += 1
    return out


verify_generic.launches = 0


class Ed25519BatchVerifier:
    """Chunked batch verifier with two device paths, dispatched per
    signature by key temperature:

    * **table path** (tables.py, K-B + K-T): keys seen >= `hot_threshold`
      times get a precomputed per-key window table on the device;
    * **generic path** (K-G): joint 2-bit-windowed double-scalarmult for
      cold keys.

    Both paths ship raw bytes (96 B/sig + a key index or slot) to the
    device.  Unlike the reference, chunks are not padded: the kernels take
    any length, so there is nothing to bound recompiles for.

    Devices: `devices` (a sequence; a card may repeat, and its shards then
    run on streams of their own), else `device`, else every visible card,
    as the reference shards over every visible device.  Each chunk is split
    into contiguous parts, one a device; an empty part launches nothing.
    The key rows go to every device, and every hot key's table is built by
    K-B on every distinct device (one slot map, one table tensor a device).

    Threads: a call holds the verifier's lock from its host prep to its
    last launch, so calls from several threads (the catchup pipeline's
    worker generations) never interleave on the pk cache, the use counts
    or the key tables; and KeyTableCache.install waits for the launches
    that read a table before it rewrites a slot, whatever stream they ran
    on.
    """

    def __init__(self, chunk_size: int = 8192, table_slots: int = 192,
                 hot_threshold: int = 4, *, device=None, devices=None):
        self.devices = resolve_shards(device, devices)
        self.device = self.devices[0]
        self._shards = Shards(self.devices)
        self.chunk_size = chunk_size
        self.hot_threshold = hot_threshold
        # pk -> (3, 32) uint8 canonical encodings of (x, y, t) of -A, or
        # None if the key fails decoding.  Decompression (two field exps in
        # python ints) is the dominant host prep cost, so this cache is
        # load-bearing for end-to-end throughput.
        self._pk_cache: dict = {}
        self._tables = _tables.KeyTableCache(table_slots, device=self.device,
                                             mirrors=self.devices[1:])
        self._use_counts: dict = {}
        self.stats = {"table_sigs": 0, "generic_sigs": 0, "rejected_prep": 0,
                      "tables_built": 0}
        self._lock = make_lock("accel.ed25519.verifier")

    @staticmethod
    def _decode_pk(pk: bytes):
        """Decompress pk to the encodings of -A; None if not on the curve.
        Precondition: canonicality + small-order gates already applied."""
        y = int.from_bytes(pk, "little") & ((1 << 255) - 1)
        x = _recover_x(y, pk[31] >> 7)
        if x is None:
            return None
        neg_x = (P - x) % P
        return np.frombuffer(
            neg_x.to_bytes(32, "little") + y.to_bytes(32, "little")
            + (neg_x * y % P).to_bytes(32, "little"),
            dtype=np.uint8).reshape(3, 32)

    def verify(self, pks: Sequence[bytes], sigs: Sequence[bytes],
               msgs: Sequence[bytes]) -> np.ndarray:
        return self.verify_async(pks, sigs, msgs)()

    def verify_async(self, pks: Sequence[bytes], sigs: Sequence[bytes],
                     msgs: Sequence[bytes]):
        """Dispatch-only half: host prep + kernel enqueue, no sync.  Returns
        a collector callable; invoking it waits on the CUDA event recorded
        after each shard's last launch, copies the verdicts home and
        returns them.  The host prep, up to the last launch enqueued, is
        the `accel.ed25519.prep` span (args n, hot, cold, cpu_s); its timer
        takes the prep's CPU seconds, since a worker thread's wall time
        holds its waits for the GIL."""
        n = len(pks)
        if len(sigs) != n or len(msgs) != n:
            raise ValueError("pks, sigs and msgs differ in length")
        with self._lock, tracing.timed_span("accel.ed25519.prep", cpu=True,
                                              n=n):
            return self._verify_async(pks, sigs, msgs, n)

    def _verify_async(self, pks, sigs, msgs, n: int):
        _registry().histogram("accel.ed25519.batch-size").update(n)

        # -- vectorized encoding checks ---------------------------------
        ok = np.ones(n, dtype=bool)
        if all(len(s) == 64 for s in sigs) and all(len(p) == 32 for p in pks):
            sig_mat = np.frombuffer(b"".join(sigs), dtype=np.uint8) \
                .reshape(n, 64).copy()
            pk_mat = np.frombuffer(b"".join(pks), dtype=np.uint8) \
                .reshape(n, 32).copy()
        else:
            sig_mat = np.zeros((n, 64), dtype=np.uint8)
            pk_mat = np.zeros((n, 32), dtype=np.uint8)
            for i in range(n):
                s, p = sigs[i], pks[i]
                if len(s) == 64 and len(p) == 32:
                    sig_mat[i] = np.frombuffer(bytes(s), dtype=np.uint8)
                    pk_mat[i] = np.frombuffer(bytes(p), dtype=np.uint8)
                else:
                    ok[i] = False
        ok &= _lt_vec(sig_mat[:, 32:], _L_BYTES)            # S canonical
        ok &= ~_small_order_vec(sig_mat[:, :32])            # R not small order
        pk_no_sign = pk_mat.copy()
        pk_no_sign[:, 31] &= 0x7F
        ok &= _lt_vec(pk_no_sign, _P_BYTES)                 # pk canonical
        ok &= ~_small_order_vec(pk_mat)                     # pk not small order

        # -- per-element: pk decompress (cached) + challenge hash --------
        _zero32 = b"\x00" * 32
        h_rows = [_zero32] * n
        cache = self._pk_cache
        counts = self._use_counts
        sha512 = hashlib.sha512
        for i in range(n):
            if not ok[i]:
                continue
            pk = bytes(pks[i])
            cached = cache.get(pk, _PK_UNSEEN)
            if cached is _PK_UNSEEN:
                cached = self._decode_pk(pk)
                if len(cache) < 1_000_000:
                    cache[pk] = cached
            if cached is None:
                ok[i] = False
                continue
            counts[pk] = counts.get(pk, 0) + 1
            sig = bytes(sigs[i])
            h = int.from_bytes(sha512(sig[:32] + pk + bytes(msgs[i])).digest(),
                               "little") % L
            h_rows[i] = h.to_bytes(32, "little")
        h_raw = np.frombuffer(b"".join(h_rows), dtype=np.uint8).reshape(n, 32)
        rejected = int(n - ok.sum())
        self.stats["rejected_prep"] += rejected
        _registry().counter("accel.ed25519.rejected-prep").inc(rejected)

        # -- hot/cold key split -----------------------------------------
        tabs = self._tables
        live = [i for i in range(n) if ok[i]]
        hot_pks = set()
        for i in live:
            pk = bytes(pks[i])
            if pk in tabs.slot_of or counts.get(pk, 0) >= self.hot_threshold:
                hot_pks.add(pk)
        to_install = [pk for pk in hot_pks if pk not in tabs.slot_of]
        if to_install:
            installed = tabs.install(
                [(pk, cache[pk]) for pk in to_install], protect=hot_pks)
            self.stats["tables_built"] += len(installed)
            _registry().counter("accel.ed25519.tables-built") \
                .inc(len(installed))
            hot_pks -= {pk for pk in to_install if pk not in installed}
        hot_idx = [i for i in live if bytes(pks[i]) in hot_pks]
        cold_idx = [i for i in live if bytes(pks[i]) not in hot_pks]
        self.stats["table_sigs"] += len(hot_idx)
        self.stats["generic_sigs"] += len(cold_idx)
        tracing.annotate(hot=len(hot_idx), cold=len(cold_idx))
        _registry().counter("accel.ed25519.table-sigs").inc(len(hot_idx))
        _registry().counter("accel.ed25519.generic-sigs").inc(len(cold_idx))

        shards = self._shards
        pending = []   # (shard, signature indices, verdicts)

        # -- table path (hot keys): raw bytes + slot ids -----------------
        if hot_idx:
            idx = np.asarray(hot_idx)
            slots = np.asarray([tabs.lookup(bytes(pks[i])) for i in hot_idx],
                               dtype=np.int32)
            bases = {d: _tables.base_point_table(d) for d in self.devices}
            for k, dev, sel, spans in self._plan(len(idx)):
                with shards.on(k):
                    s_raw = upload(sig_mat[idx[sel], 32:], dev)
                    hh = upload(h_raw[idx[sel]], dev)
                    rb = upload(sig_mat[idx[sel], :32], dev)
                    sl_d = upload(slots[sel], dev)
                    table, base = tabs.table_on(dev), bases[dev]
                    shards.use(k, table, base)
                    for lo, hi, at in spans:
                        pending.append((k, idx[lo:hi], _tables.verify_tables(
                            s_raw[at:at + hi - lo], hh[at:at + hi - lo],
                            sl_d[at:at + hi - lo], rb[at:at + hi - lo], table,
                            base)))

        # -- generic path (cold keys): de-duplicated key rows ------------
        if cold_idx:
            idx = np.asarray(cold_idx)
            key_of = {}
            key_rows = []
            kidx = np.zeros(len(idx), dtype=np.int32)
            for j, i in enumerate(cold_idx):
                pk = bytes(pks[i])
                ki = key_of.get(pk)
                if ki is None:
                    ki = key_of[pk] = len(key_rows)
                    key_rows.append(cache[pk])
                kidx[j] = ki
            key_rows = np.stack(key_rows)
            for k, dev, sel, spans in self._plan(len(idx)):
                with shards.on(k):
                    keys = upload(key_rows, dev)
                    s_raw = upload(sig_mat[idx[sel], 32:], dev)
                    hh = upload(h_raw[idx[sel]], dev)
                    rb = upload(sig_mat[idx[sel], :32], dev)
                    kidx_d = upload(kidx[sel], dev)
                    for lo, hi, at in spans:
                        pending.append((k, idx[lo:hi], verify_generic(
                            s_raw[at:at + hi - lo], hh[at:at + hi - lo],
                            kidx_d[at:at + hi - lo], keys,
                            rb[at:at + hi - lo])))

        # one event a shard, after its last launch
        done = [shards.join(k, *(v for kk, _, v in pending if kk == k))
                for k in range(len(shards))]
        if hot_idx:
            tabs.note_readers(done)

        def collect() -> np.ndarray:
            for event in done:
                if event is not None:
                    event.synchronize()
            out = np.zeros(n, dtype=bool)
            for _, which, verdict in pending:
                out[which] = verdict.cpu().numpy()
            return out & ok

        return collect

    def _plan(self, n: int):
        """Yields (shard, device, rows, spans) for the shards with work:
        each chunk of n rows split into contiguous parts, one a shard; rows
        are the indices of the shard's parts, in order, and spans its parts
        as (lo, hi, offset in rows)."""
        cs = self.chunk_size
        chunk_parts = [[(c + lo, c + hi) for lo, hi in parts(min(cs, n - c),
                                                               len(self.devices))]
                       for c in range(0, n, cs)]
        for k, dev in enumerate(self.devices):
            spans, at = [], 0
            for per_shard in chunk_parts:
                lo, hi = per_shard[k]
                if hi > lo:
                    spans.append((lo, hi, at))
                    at += hi - lo
            if spans:
                sel = np.concatenate([np.arange(lo, hi) for lo, hi, _ in spans])
                yield k, dev, sel, spans


_verifiers: dict = {}  # (chunk, tail floor, hot threshold, devices) -> verifier
_verifiers_lock = make_lock("accel.ed25519.verifiers")


def _verifier_for(chunk_size: int, tail_floor: int, hot_threshold: int,
                  device, devices=None) -> Ed25519BatchVerifier:
    """The cached verifier of these arguments, keyed as the reference keys
    its own (stellar_core_tpu/accel/ed25519.py:495-505) and on the
    devices: two callers that differ only in `tail_floor` get two
    verifiers, with their own pk caches, use counts and key tables."""
    devs = resolve_shards(device, devices)
    key = (chunk_size, tail_floor, hot_threshold, devs)
    with _verifiers_lock:
        v = _verifiers.get(key)
        if v is None:
            v = _verifiers[key] = Ed25519BatchVerifier(
                chunk_size, hot_threshold=hot_threshold, devices=devs)
    return v


def verify_batch(pks, sigs, msgs, chunk_size: int = 512,
                 tail_floor: int = 256, hot_threshold: int = 4, *,
                 device=None, devices=None) -> np.ndarray:
    """Verdicts for (pk, sig, msg) triples.  `tail_floor` keys the cached
    verifier, as in the reference, and has no other effect: the port does
    not pad its chunks.  `device` / `devices`: see Ed25519BatchVerifier."""
    return _verifier_for(chunk_size, tail_floor, hot_threshold, device,
                         devices).verify(pks, sigs, msgs)


def verify_batch_async(pks, sigs, msgs, chunk_size: int = 512,
                       tail_floor: int = 256, hot_threshold: int = 4, *,
                       device=None, devices=None):
    """Dispatch now, sync later: returns the collector callable (see
    Ed25519BatchVerifier.verify_async).  `tail_floor` keys the cached
    verifier and has no other effect."""
    return _verifier_for(chunk_size, tail_floor, hot_threshold, device,
                         devices).verify_async(pks, sigs, msgs)
