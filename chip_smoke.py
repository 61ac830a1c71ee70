#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from stellar_core_tpu_torch/csrc (nvcc, at
first use), holds each one against its plain PyTorch version on the card,
checks the adversarial verdicts, then drives the batch verifier's two main
paths at the repo's realistic sizes:

* hot keys (bench.py config #2): 65,536 signatures over 64 keys, 120-byte
  messages, chunk 16384, hot_threshold 4 -- key tables built by K-B, verified
  by K-T;
* cold keys (the catchup replay default, hot_threshold 1 << 62): 65,536
  signatures over 4,096 keys, chunk 8192 -- verified by K-G;

with every 100th signature's R corrupted (655 bad, 64,881 accepted).  Each
phase prints one JSON line; then the card's name and power limit as
nvidia-smi gives them, the kernels line, and last
{"ok": true, "device": {...}}.  Any failure raises: the exit code is then
not 0 and the last line is not printed.  Without CUDA it exits 2.

Signatures come from libsodium where it loads, else from the pure-Python
RFC 8032 signer below (deterministic signing: the same bytes libsodium
makes), which signs a few thousand distinct triples and tiles them.
"""

from __future__ import annotations

import hashlib
import json
import random
import subprocess
import sys
import time

import numpy as np
import torch

from stellar_core_tpu_torch import _cuda_build
from stellar_core_tpu_torch.accel import curve, ed25519, field, tables
from stellar_core_tpu_torch.crypto import sodium

P = field.P
L = ed25519.L
N_SIGS = 65536
HOT_KEYS, HOT_CHUNK = 64, 16384
COLD_KEYS, COLD_CHUNK = 4096, 8192
FE_PAIRS = 100_000

# H100 SXM int32 multiply-add rate: 132 SMs x 64 INT32 lanes x 1.98 GHz
# (NVIDIA's H100 white paper: 33.5 TOPS counting multiply and add apart)
IMAD_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
# 32x32->64 products in one fe_mul / fe_sq of csrc/fe25519.cuh
MUL_IMADS, SQ_IMADS = 100, 55


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# -- pure-Python RFC 8032 signer (used only where libsodium is missing) -----

def _pt_add(p, q):
    """Extended-coordinate add (complete, a = -1) on python ints."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * t2 % P * curve.D2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


_B_POW2 = []   # B * 2^i, i = 0..255, extended coordinates


def _base_mult(k: int):
    if not _B_POW2:
        pt = (curve.BX, curve.BY, 1, curve.BX * curve.BY % P)
        for _ in range(256):
            _B_POW2.append(pt)
            pt = _pt_add(pt, pt)
    acc = (0, 1, 1, 0)
    for i in range(k.bit_length()):
        if (k >> i) & 1:
            acc = _pt_add(acc, _B_POW2[i])
    return acc


def _encode(pt) -> bytes:
    x, y, z, _ = pt
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def py_keypair(seed: bytes):
    """(pk, sk) from a 32-byte seed, as crypto_sign_seed_keypair."""
    d = hashlib.sha512(seed).digest()
    a = int.from_bytes(d[:32], "little")
    a = (a & ((1 << 254) - 8)) | (1 << 254)
    pk = _encode(_base_mult(a))
    return pk, (a, d[32:], pk)


def py_sign(msg: bytes, sk) -> bytes:
    a, prefix, pk = sk
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    big_r = _encode(_base_mult(r))
    h = int.from_bytes(hashlib.sha512(big_r + pk + msg).digest(), "little") % L
    return big_r + ((r + h * a) % L).to_bytes(32, "little")


class Signer:
    """libsodium where it loads, else the RFC 8032 signer above."""

    def __init__(self):
        self.name = "libsodium" if sodium.available() else "python-rfc8032"

    def keypair(self, seed: bytes):
        if sodium.available():
            return sodium.sign_seed_keypair(seed)
        return py_keypair(seed)

    def sign(self, msg: bytes, sk) -> bytes:
        if sodium.available():
            return sodium.sign_detached(msg, sk)
        return py_sign(msg, sk)


# -- the adversarial vectors of tests/test_accel_ed25519.py:43-168 ----------

def adversarial_cases(signer: Signer):
    """[(name, [(pk, sig, msg)], expected verdicts)].  The expected
    verdicts are libsodium's, fixed here so the check stands where it is
    missing."""
    out = []

    def kp(rng):
        return signer.keypair(bytes(rng.randrange(256) for _ in range(32)))

    rng = random.Random(42)
    cases = []
    for i in range(24):
        pk, sk = kp(rng)
        msg = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 150)))
        sig = signer.sign(msg, sk)
        kind = i % 6
        if kind == 1:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        elif kind == 2:
            sig = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
        elif kind == 3:
            msg = msg + b"!"
        elif kind == 4:
            pk = kp(rng)[0]
        cases.append((pk, sig, msg))
    out.append(("honest-and-corrupted", cases, [i % 6 in (0, 5) for i in range(24)]))

    rng = random.Random(43)
    cases = []
    for _ in range(4):
        pk, sk = kp(rng)
        sig = signer.sign(b"malleability", sk)
        s_int = int.from_bytes(sig[32:], "little")
        cases.append((pk, sig, b"malleability"))
        cases.append((pk, sig[:32] + (s_int + L).to_bytes(32, "little"),
                      b"malleability"))
    out.append(("non-canonical-S+L", cases, [True, False] * 4))

    rng = random.Random(44)
    pk, sk = kp(rng)
    sig = signer.sign(b"m", sk)
    out.append(("high-bit-S", [(pk, sig[:63] + bytes([sig[63] | 0xE0]), b"m")],
                [False]))

    rng = random.Random(45)
    pk, sk = kp(rng)
    sig = signer.sign(b"torsion", sk)
    cases = []
    for base in (0, 1, ed25519._Y8A, ed25519._Y8B, P - 1, P, P + 1):
        for sign in (0, 0x80):
            b = bytearray(base.to_bytes(32, "little"))
            b[31] |= sign
            cases.append((pk, bytes(b) + sig[32:], b"torsion"))
            cases.append((bytes(b), sig, b"torsion"))
    out.append(("small-order-R-and-pk", cases, [False] * 28))

    rng = random.Random(46)
    _, sk = kp(rng)
    sig = signer.sign(b"x", sk)
    cases = [(y.to_bytes(32, "little"), sig, b"x") for y in (P + 2, P + 3)]
    y = 2
    while len(cases) < 5:
        if curve._recover_x(y, 0) is None:
            cases.append((y.to_bytes(32, "little"), sig, b"x"))
        y += 1
    out.append(("non-canonical-and-undecodable-pk", cases, [False] * 5))

    rng = random.Random(47)
    t8 = (curve._recover_x(ed25519._Y8A, 0), ed25519._Y8A)
    cases = []
    for _ in range(4):
        pk, sk = kp(rng)
        sig = signer.sign(b"mixed order", sk)
        y = int.from_bytes(pk, "little") & ((1 << 255) - 1)
        mixed = ed25519._edwards_add_affine((curve._recover_x(y, pk[31] >> 7), y), t8)
        enc = bytearray(mixed[1].to_bytes(32, "little"))
        enc[31] |= (mixed[0] & 1) << 7
        cases.append((bytes(enc), sig, b"mixed order"))
        cases.append((pk, sig, b"mixed order"))
    out.append(("torsion-mixed-pk", cases, [False, True] * 4))

    rng = random.Random(48)
    pk, sk = kp(rng)
    sig = signer.sign(b"dup", sk)
    out.append(("duplicates", [(pk, sig, b"dup")] * 35, [True] * 35))

    rng = random.Random(49)
    pk, sk = kp(rng)
    sig = signer.sign(b"z", sk)
    out.append(("wrong-lengths",
                [(pk, sig[:63], b"z"), (pk[:31], sig, b"z"), (pk, sig, b"z")],
                [False, False, True]))
    return out


def check_adversarial(signer: Signer, device) -> dict:
    """Run every adversarial case through a fresh verifier on `device`;
    raises on any verdict that differs from libsodium's."""
    v = ed25519.Ed25519BatchVerifier(chunk_size=32, device=device)
    report = {}
    for name, cases, expected in adversarial_cases(signer):
        got = v.verify([c[0] for c in cases], [c[1] for c in cases],
                       [c[2] for c in cases]).tolist()
        if sodium.available():
            oracle = [sodium.verify_detached(s, m, p) for p, s, m in cases]
            if oracle != expected:
                raise AssertionError(f"{name}: libsodium says {oracle}, "
                                     f"the fixed verdicts say {expected}")
        if got != expected:
            raise AssertionError(f"{name}: port {got} != expected {expected}")
        report[name] = len(cases)
    return report


# -- main-path data ----------------------------------------------------------

def make_batch(signer: Signer, n_keys: int, seed: int, msg_len: int):
    """N_SIGS (pk, sig, msg), key i % n_keys, every 100th R corrupted.  With
    libsodium every message is distinct; the fallback signs one message
    per key (at least 2,048 triples) and tiles them."""
    rng = np.random.default_rng(seed)
    key_seeds = rng.integers(0, 256, size=(n_keys, 32), dtype=np.uint8)
    keys = [signer.keypair(key_seeds[k].tobytes()) for k in range(n_keys)]
    n_distinct = N_SIGS if sodium.available() else max(2048, n_keys)
    msgs = rng.integers(0, 256, size=(n_distinct, msg_len), dtype=np.uint8)
    triples = []
    for t in range(n_distinct):
        pk, sk = keys[t % n_keys]
        m = msgs[t].tobytes()
        triples.append((pk, signer.sign(m, sk), m))
    pks, sigs, out_msgs = [], [], []
    for i in range(N_SIGS):
        pk, sig, m = triples[i % n_distinct]
        if i % 100 == 99:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        pks.append(pk)
        sigs.append(sig)
        out_msgs.append(m)
    return pks, sigs, out_msgs


def device_rows(pks, sigs, msgs, dev):
    """s, h, r byte rows and de-duplicated key rows of -A on `dev`, as the
    verifier's host prep makes them (all inputs here pass the prep)."""
    uniq = {}
    rows = []
    kidx = np.empty(len(pks), dtype=np.int32)
    for i, pk in enumerate(pks):
        k = uniq.get(pk)
        if k is None:
            k = uniq[pk] = len(rows)
            rows.append(ed25519.Ed25519BatchVerifier._decode_pk(pk))
        kidx[i] = k
    sig_mat = np.frombuffer(b"".join(sigs), np.uint8).reshape(-1, 64)
    h = np.frombuffer(b"".join(
        (int.from_bytes(hashlib.sha512(sig[:32] + pk + m).digest(), "little")
         % L).to_bytes(32, "little") for pk, sig, m in zip(pks, sigs, msgs)),
        np.uint8).reshape(-1, 32)
    t = lambda a: torch.from_numpy(np.array(a)).to(dev)
    return (t(sig_mat[:, 32:]), t(h), t(sig_mat[:, :32]), t(kidx),
            t(np.stack(rows)))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over `reps` calls (CUDA events),
    after one untimed call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(imads: float, nbytes: float):
    ops_ms = imads / IMAD_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


# multiply / square counts of the kernels' own code (csrc/verify.cuh)
def kg_imads() -> int:
    """K-G per signature: table (dbl + add + 4 to_pre + 3 x (to_pre + 3 x
    (add + to_pre))), 127 x (2 dbl + add_pre), encode (invert + 2 mul)."""
    sq = 4 + 127 * 8 + 254
    mul = (4 + 9 + 4 + 3 * (1 + 3 * 10)) + 127 * (8 + 8) + (11 + 2)
    return sq * SQ_IMADS + mul * MUL_IMADS


def kt_imads() -> int:
    """K-T per signature: 128 precomputed adds, encode."""
    return 254 * SQ_IMADS + (128 * 8 + 13) * MUL_IMADS


def kb_imads() -> int:
    """K-B per key, what building the table needs: x*y once, the
    sequential chain of 4 doublings between windows (252), and per window
    2 + 14 x (add + to_pre)."""
    dbl = 4 * (tables.NWIN - 1)
    return dbl * 4 * SQ_IMADS + (1 + dbl * 4 + tables.NWIN * (2 + 14 * 10)) * MUL_IMADS


def kb_imads_run() -> int:
    """K-B per key, what its one-thread-per-window design runs: thread w
    computes x*y and doubles A 4w times itself (8,064 doublings a key, 32x
    the chain's 252).  Not the bound: the bound counts the work, not the
    design's redundancy."""
    dbl = sum(4 * w for w in range(tables.NWIN))
    return dbl * 4 * SQ_IMADS + (dbl * 4 + tables.NWIN * (1 + 2 + 14 * 10)) * MUL_IMADS


KERNEL_WRAPPERS = {"K-B": tables.build_tables_into,
                   "K-T": tables.verify_tables,
                   "K-G": ed25519.verify_generic}


def drive(call) -> dict:
    """One main-path call: launch counts set to 0 just before and read just
    after, its wall seconds, and the device time of the kernels it launched
    (CUDA events recorded around each launch)."""
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    _cuda_build.launch_events = []
    try:
        t0 = time.perf_counter()
        verdicts = call()
        seconds = time.perf_counter() - t0
        events = _cuda_build.launch_events
    finally:
        _cuda_build.launch_events = None
    # the verdicts are home, so every end event has completed
    kernel_ms = sum(start.elapsed_time(end) for _, start, end in events)
    return {"verdicts": verdicts, "seconds": seconds, "kernel_ms": kernel_ms,
            "launches": {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}}


def report(run: dict) -> dict:
    """What a main-path line prints of a drive() result; busy_share is the
    kernels' device time over the call's wall time."""
    return {"seconds": run["seconds"], "sigs_per_s": N_SIGS / run["seconds"],
            "launches": run["launches"], "kernel_ms": run["kernel_ms"],
            "busy_share": run["kernel_ms"] / (1e3 * run["seconds"])}


def smi_line(dev) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", f"--id={dev.index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    return run(torch.device("cuda", torch.cuda.current_device()))


def run(dev) -> int:
    kind = torch.cuda.get_device_name(dev)
    smi = smi_line(dev)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    _cuda_build.build()
    ptxas = {}
    for name in _cuda_build.SOURCES:
        ptxas.update(_cuda_build.ptxas_report(name))
        _cuda_build.library(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

    signer = Signer()
    t0 = time.perf_counter()
    hot = make_batch(signer, HOT_KEYS, seed=7, msg_len=120)
    cold = make_batch(signer, COLD_KEYS, seed=8, msg_len=120)
    emit({"phase": "inputs", "signer": signer.name,
          "seconds": time.perf_counter() - t0})

    # -- kernels against their plain versions on the card -----------------
    rng = np.random.default_rng(1)
    edge = [0, 1, 2, 19, P - 2, P - 1, P, P + 1, P + 18, (1 << 255) - 1,
            1 << 254, (1 << 255) - 20]
    enc = np.frombuffer(b"".join(x.to_bytes(32, "little") for x in edge),
                        np.uint8).reshape(-1, 32)
    a = rng.integers(0, 256, size=(FE_PAIRS, 32), dtype=np.uint8)
    b = rng.integers(0, 256, size=(FE_PAIRS, 32), dtype=np.uint8)
    a[:len(edge)], b[:len(edge)] = enc, enc[::-1]
    a_d, b_d = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    fe_bad = {}
    for op, name in enumerate(field.FE_CHECK_OPS):
        got = field.fe_check(a_d, b_d, op)
        want = field.fe_check_plain(a_d, b_d, op)
        fe_bad[name] = int((got != want).any(dim=1).sum())
    emit({"phase": "field-vs-plain", "pairs": FE_PAIRS, "mismatches": fe_bad})
    if any(fe_bad.values()):
        raise AssertionError(f"field ops disagree with the plain version: {fe_bad}")

    timing = {}
    # K-G at the cold path's chunk shape
    s, h, r, kidx, keys = device_rows(*cold, dev)
    kg_args = (s[:COLD_CHUNK], h[:COLD_CHUNK], kidx[:COLD_CHUNK], keys,
               r[:COLD_CHUNK])
    got = ed25519.verify_generic(*kg_args)
    want = ed25519.verify_forward_raw(*kg_args)
    kg_bad = int((got != want).sum())
    timing["K-G"] = {
        "ms": cuda_ms(lambda: ed25519.verify_generic(*kg_args), 5),
        "plain_ms": cuda_ms(lambda: ed25519.verify_forward_raw(*kg_args), 1),
        "bound": bound_ms(COLD_CHUNK * kg_imads(),
                          COLD_CHUNK * (96 + 4 + 1) + keys.numel()),
        "max_abs_err": int((got.int() - want.int()).abs().max())}

    # K-B on 32 keys, compared as canonical values
    s, h, r, slots, hot_keys = device_rows(*hot, dev)
    xy = hot_keys[:tables.BUILD_K, :2].contiguous()
    kb_keys = xy.shape[0]
    kb_slots = torch.arange(kb_keys, dtype=torch.int32, device=dev)
    kb_table = tables.new_table(kb_keys, dev)
    tables.build_tables_into(kb_table, kb_slots, xy)
    # both sides as canonical 32-byte encodings: equal bytes, equal values
    plain_tab = field.to_bytes(tables.build_tables(
        field.from_bytes(xy[:, 0]), field.from_bytes(xy[:, 1])))
    diff = (kb_table.int() - plain_tab.int()).abs()
    kb_bad = int((diff.amax(dim=-1) > 0).sum())
    timing["K-B"] = {
        "ms": cuda_ms(lambda: tables.build_tables_into(kb_table, kb_slots, xy), 3),
        "plain_ms": cuda_ms(lambda: tables.build_tables(
            field.from_bytes(xy[:, 0]), field.from_bytes(xy[:, 1])), 1),
        "bound": bound_ms(kb_keys * kb_imads(),
                          kb_table.numel() + xy.numel() + 4 * kb_keys),
        "max_abs_err": int(diff.max())}

    # K-T at the hot path's chunk shape, on a table built by K-B; the plain
    # version reads the same bytes
    key_table = tables.new_table(HOT_KEYS, dev)
    tables.build_tables_into(
        key_table, torch.arange(HOT_KEYS, dtype=torch.int32, device=dev),
        hot_keys[:, :2].contiguous())
    base = tables.base_point_table(dev)
    kt_args = (s[:HOT_CHUNK], h[:HOT_CHUNK], slots[:HOT_CHUNK], r[:HOT_CHUNK],
               key_table, base)
    got = tables.verify_tables(*kt_args)
    want = tables.verify_tables_forward(*kt_args)
    kt_bad = int((got != want).sum())
    timing["K-T"] = {
        "ms": cuda_ms(lambda: tables.verify_tables(*kt_args), 5),
        "plain_ms": cuda_ms(lambda: tables.verify_tables_forward(*kt_args), 1),
        "bound": bound_ms(HOT_CHUNK * kt_imads(),
                          HOT_CHUNK * (96 + 4 + 1) + key_table.numel()
                          + base.numel()),
        "max_abs_err": int((got.int() - want.int()).abs().max())}
    emit({"phase": "kernels-vs-plain",
          "K-G": {"signatures": COLD_CHUNK, "mismatches": kg_bad,
                  "imads_per_sig": kg_imads()},
          "K-B": {"keys": kb_keys, "mismatched_entries": kb_bad,
                  "imads_per_key_needed": kb_imads(),
                  "imads_per_key_run": kb_imads_run()},
          "K-T": {"signatures": HOT_CHUNK, "mismatches": kt_bad,
                  "imads_per_sig": kt_imads()}})
    if kg_bad or kb_bad or kt_bad:
        raise AssertionError("a kernel disagrees with its plain version")
    del plain_tab

    # -- adversarial vectors ----------------------------------------------
    emit({"phase": "adversarial", "oracle": "libsodium" if sodium.available()
          else "fixed verdicts", "cases": check_adversarial(signer, dev)})

    # -- main path, hot keys (bench config #2) -----------------------------
    # through the module-level entry that catchup and admission call, with
    # no device argument (the default device, the cached verifier)
    expect = N_SIGS - sum(1 for i in range(N_SIGS) if i % 100 == 99)  # 64,881
    ed25519._verifiers.clear()
    first = drive(lambda: ed25519.verify_batch(*hot, chunk_size=HOT_CHUNK))
    steady = drive(lambda: ed25519.verify_batch(*hot, chunk_size=HOT_CHUNK))
    stats = ed25519._verifier_for(HOT_CHUNK, 4, None).stats
    emit({"phase": "main-hot", "accepted": int(first["verdicts"].sum()),
          "stats": stats, "first_call": report(first),
          "steady": report(steady)})
    if int(first["verdicts"].sum()) != expect \
            or int(steady["verdicts"].sum()) != expect:
        raise AssertionError(f"hot path accepted {int(first['verdicts'].sum())}, "
                             f"{int(steady['verdicts'].sum())}, not {expect}")
    hot_launches = first["launches"]
    if stats["table_sigs"] != 2 * N_SIGS or hot_launches["K-B"] < 1 \
            or hot_launches["K-T"] < 1 or hot_launches["K-G"] != 0:
        raise AssertionError(f"hot path did not run on K-B/K-T: {stats} "
                             f"{hot_launches}")
    hot_runs = first, steady

    # -- main path, cold keys (catchup replay default) ---------------------
    def cold_call():
        return ed25519.verify_batch(*cold, chunk_size=COLD_CHUNK,
                                    hot_threshold=1 << 62)

    first = drive(cold_call)
    steady = drive(cold_call)
    stats = ed25519._verifier_for(COLD_CHUNK, 1 << 62, None).stats
    emit({"phase": "main-cold", "accepted": int(first["verdicts"].sum()),
          "stats": stats, "first_call": report(first),
          "steady": report(steady)})
    if int(first["verdicts"].sum()) != expect \
            or int(steady["verdicts"].sum()) != expect:
        raise AssertionError(f"cold path accepted {int(first['verdicts'].sum())}, "
                             f"{int(steady['verdicts'].sum())}, not {expect}")
    cold_launches = first["launches"]
    if stats["generic_sigs"] != 2 * N_SIGS or cold_launches != {
            "K-B": 0, "K-T": 0, "K-G": N_SIGS // COLD_CHUNK}:
        raise AssertionError(f"cold path did not run on K-G: {stats} "
                             f"{cold_launches}")
    cold_runs = first, steady

    emit({"phase": "end-to-end", "signer": signer.name,
          "hot_sigs_per_s": N_SIGS / hot_runs[0]["seconds"],
          "hot_steady_sigs_per_s": N_SIGS / hot_runs[1]["seconds"],
          "cold_sigs_per_s": N_SIGS / cold_runs[0]["seconds"],
          "cold_steady_sigs_per_s": N_SIGS / cold_runs[1]["seconds"]})

    # -- the kernels line -------------------------------------------------
    meta = {
        "K-G": ("stellar_core_tpu_torch/csrc/verify_generic.cu",
                "stellar_core_tpu/accel/ed25519.py:173",
                cold_launches["K-G"]),
        "K-B": ("stellar_core_tpu_torch/csrc/tables.cu",
                "stellar_core_tpu/accel/tables.py:51", hot_launches["K-B"]),
        "K-T": ("stellar_core_tpu_torch/csrc/tables.cu",
                "stellar_core_tpu/accel/tables.py:109", hot_launches["K-T"]),
    }
    kernels = []
    for name, (source, replaces, count) in meta.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": count,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": None})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
