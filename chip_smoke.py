#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from stellar_core_tpu_torch/csrc (nvcc, at
first use; K-G, K-W, K-T and K-B must show no spills, K-G and K-W no stack
that could hold their 16-entry tables, K-T and K-B none that could hold a
point), holds each one against its plain PyTorch version on the card (K-G
also at a ragged 8,191 signatures and at the admission chunk of 2,048, K-T
at a ragged 16,383, at 2,048 and with a slot outside the table, K-B at 32
keys and on the base point alone), measures K-B's chain floor (252
doublings of one warp's chain), checks the adversarial verdicts on the
generic path and on the table path, then drives the batch verifier's two
main paths and the quorum-intersection checker at the repo's realistic
sizes:

* hot keys (bench.py config #2): 65,536 signatures over 64 keys, 120-byte
  messages, chunk 16384, hot_threshold 4 -- key tables built by K-B, verified
  by K-T;
* cold keys (the catchup replay default, hot_threshold 1 << 62): 65,536
  signatures over 4,096 keys, chunk 8192 -- verified by K-G;

with every 100th signature's R corrupted (655 bad, 64,881 accepted); and

* the quorum-intersection check of bench.py config 5's largest map, asym7
  (27 validators in 7 organisations, 9,215,488 minimal-quorum hits, a
  frontier of up to 5,824,512 rows), through kernels K-QF and K-QC, one
  launch of each a depth, its widest depths too; a splitting
  tier-1-width map (7 orgs x 3 validators, 3-of-7) whose split must be
  the JAX package's; asym5 with capacity buckets (8, 16), whose depths the
  JAX package runs host-chunked (here on the card, the frontier never
  downloaded); and a 257-node map (rows of 9 words, K-QF's wide path),
  intersecting and split.  K-QF is held against its plain version on
  each of its three paths (fast, wide rows, tables in global memory) and
  K-QC at the widest asym7 depth, 11,649,024 children, and both are timed
  there and at 65,536 children;

* the signature seam, catchup replay's verdict half (signature-seam):
  about 40,960 transaction envelopes shaped like bench.py's replay
  archive (120 accounts, every 4th co-signed by an extra signer, 40
  payments a ledger, 1,024 ledgers; about 51,200 signatures, every 100th
  corrupted), decoded with the port's XDR, hashed as
  TransactionSignaturePayload, verified by ``verify_batch_async`` as
  catchup replay calls it (chunk 2,048; once at the replay default
  hot_threshold 1 << 62, K-G, once at the bench's 4, K-B + K-T), seeded
  into the verify cache and checked by ``SignatureChecker``: every
  envelope's result must be the oracle's, with no verdict recomputed;

* the graft entry (stellar_core_tpu_torch/graft_entry.py): K-W, the
  windows form of K-G, against its plain version on the cold path's 8,192
  signatures, its fused accept count, and ``entry()``'s step; then the
  multi-card forms, as shards on the one card the machine has:
  ``dryrun_multigpu(4)``, both verify paths with ``devices=[card, card]``
  and asym5 and the split map through the sharded quorum checker.

Each phase prints one JSON line; then the card's name and power limit as
nvidia-smi gives them, the kernels line, and last
{"ok": true, "device": {...}}.  Any failure raises: the exit code is then
not 0 and the last line is not printed.  Without CUDA it exits 2.

Signatures come from the port's crypto/sodium.py: libsodium where it
loads, else its fallback, the pure-Python RFC 8032 code
(stellar_core_tpu_torch/crypto/rfc8032.py; deterministic signing: the
same bytes libsodium makes), which is slow: the inputs then sign a few
thousand distinct triples (and envelopes) and tile them.
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

from stellar_core_tpu_torch import _cuda_build, graft_entry
from stellar_core_tpu_torch import testutils as qmaps
from stellar_core_tpu_torch import xdr as X
from stellar_core_tpu_torch.accel import curve, ed25519, field, quorum, tables
from stellar_core_tpu_torch.crypto import keys as crypto_keys
from stellar_core_tpu_torch.crypto import sodium
from stellar_core_tpu_torch.crypto.sha import sha256
from stellar_core_tpu_torch.device import Shards, parts
from stellar_core_tpu_torch.herder.quorum_intersection import (
    QuorumIntersectionChecker)
from stellar_core_tpu_torch.transactions.signature_checker import (
    SignatureChecker)
from stellar_core_tpu_torch.util.metrics import registry
from stellar_core_tpu_torch.xdr import codec as xdr_codec

P = field.P
L = ed25519.L
N_SIGS = 65536
HOT_KEYS, HOT_CHUNK = 64, 16384
COLD_KEYS, COLD_CHUNK = 4096, 8192
# the admission pipeline's chunk (stellar_core_tpu/herder/admission.py:95),
# and a ragged chunk whose last warp of quads is partial
ADMISSION_CHUNK, RAGGED_N = 2048, COLD_CHUNK - 1
# a K-G / K-W thread's 16-entry table, were it a local array; a point's
# four coordinates of 10 limbs (K-T's partial sums, K-B's chain points)
TABLE_BYTES = 16 * 4 * 40
POINT_BYTES = 4 * 40
# K-B's chain: 4 doublings between its 64 windows
CHAIN_DBLS = 4 * 63
FE_PAIRS = 100_000

# H100 SXM int32 multiply-add rate: 132 SMs x 64 INT32 lanes x 1.98 GHz
# (NVIDIA's H100 white paper: 33.5 TOPS counting multiply and add apart)
IMAD_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
# 32x32->64 products in one fe_mul / fe_sq of csrc/fe25519.cuh
MUL_IMADS, SQ_IMADS = 100, 55
# H100 SXM __popc rate: 16 results per clock per SM at compute capability
# 9.0 (CUDA C++ Programming Guide, "Arithmetic Instructions" throughput
# table, row "population count"), x 132 SMs x 1.98 GHz
POPC_PER_S = 132 * 16 * 1.98e9

# The JAX package's results, fixed here so the checks stand on the card:
# from its TPUQuorumIntersectionChecker on its CPU backend (asym7 also
# from its native C engine, QuorumIntersectionChecker._check_native());
# tests/test_torch_chip_smoke.py checks each against the JAX package.
ASYM7_MAX_QUORUMS = 9_215_488
ASYM5_MAX_QUORUMS = 27_584
# org_qmap(7, 3, 3, 2): the two sides as indices i of testutils.nid(i)
SPLIT_MAP = (7, 3, 3, 2)
SPLIT_SIDES = ([0, 1, 300, 301, 600, 601],
               [2, 302, 602, 100, 101, 102, 400, 401, 402, 200, 201, 202,
                500, 501, 502])
SPLIT_MAX_QUORUMS = 16
# asym7's frontier peak (the JAX package's TPUQuorumIntersectionChecker on
# its CPU backend, about 30 s; tests/test_torch_chip_smoke.py checks it),
# and asym5's on capacity buckets (8, 16)
ASYM7_FRONTIER_PEAK = 5_824_512
LADDER_FRONTIER_PEAK = 19_968
# maps of more than 256 nodes: watched_org_qmap(*WIDE_MAP) (257 nodes,
# rows of 9 words), intersecting, and its split form; the sides as
# indices i of testutils.nid(i)
WIDE_MAP = (4, 3, 3, 2, 245)
WIDE_MAX_QUORUMS, WIDE_FRONTIER_PEAK = 624, 144
WIDE_SPLIT_MAP = (4, 3, 2, 2, 245)
WIDE_SPLIT_SIDES = ([0, 1, 300, 301],
                    [2, 302, 100, 101, 102, 200, 201, 202])
WIDE_SPLIT_MAX_QUORUMS = 4
# K-QF's comparison: child rows of one depth; rows of the map whose tables
# exceed shared memory (its plain version holds [rows, 4,352 sets, 8]
# int64 intermediates)
QF_ROWS = 65536
QF_ROWS_GLOBAL = 4096


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# -- the adversarial vectors of tests/test_accel_ed25519.py:43-168 ----------

def signer_name() -> str:
    """Who signs the inputs: crypto/sodium.py signs with libsodium where it
    loads, else with the pure-Python crypto/rfc8032.py (the same bytes)."""
    return "libsodium" if sodium.available() else "python-rfc8032"


def adversarial_cases():
    """[(name, [(pk, sig, msg)], expected verdicts)].  The expected
    verdicts are libsodium's, fixed here so the check stands where it is
    missing."""
    out = []

    def kp(rng):
        return sodium.sign_seed_keypair(
            bytes(rng.randrange(256) for _ in range(32)))

    rng = random.Random(42)
    cases = []
    for i in range(24):
        pk, sk = kp(rng)
        msg = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 150)))
        sig = sodium.sign_detached(msg, sk)
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
        sig = sodium.sign_detached(b"malleability", sk)
        s_int = int.from_bytes(sig[32:], "little")
        cases.append((pk, sig, b"malleability"))
        cases.append((pk, sig[:32] + (s_int + L).to_bytes(32, "little"),
                      b"malleability"))
    out.append(("non-canonical-S+L", cases, [True, False] * 4))

    rng = random.Random(44)
    pk, sk = kp(rng)
    sig = sodium.sign_detached(b"m", sk)
    out.append(("high-bit-S", [(pk, sig[:63] + bytes([sig[63] | 0xE0]), b"m")],
                [False]))

    rng = random.Random(45)
    pk, sk = kp(rng)
    sig = sodium.sign_detached(b"torsion", sk)
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
    sig = sodium.sign_detached(b"x", sk)
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
        sig = sodium.sign_detached(b"mixed order", sk)
        y = int.from_bytes(pk, "little") & ((1 << 255) - 1)
        mixed = ed25519._edwards_add_affine((curve._recover_x(y, pk[31] >> 7), y), t8)
        enc = bytearray(mixed[1].to_bytes(32, "little"))
        enc[31] |= (mixed[0] & 1) << 7
        cases.append((bytes(enc), sig, b"mixed order"))
        cases.append((pk, sig, b"mixed order"))
    out.append(("torsion-mixed-pk", cases, [False, True] * 4))

    rng = random.Random(48)
    pk, sk = kp(rng)
    sig = sodium.sign_detached(b"dup", sk)
    out.append(("duplicates", [(pk, sig, b"dup")] * 35, [True] * 35))

    rng = random.Random(49)
    pk, sk = kp(rng)
    sig = sodium.sign_detached(b"z", sk)
    out.append(("wrong-lengths",
                [(pk, sig[:63], b"z"), (pk[:31], sig, b"z"), (pk, sig, b"z")],
                [False, False, True]))
    return out


def check_adversarial(device, hot_threshold: int) -> dict:
    """Run every adversarial case through a fresh verifier on `device`;
    raises on any verdict that differs from libsodium's.  hot_threshold
    1 << 62 keeps every key on the generic path (K-G); 1 sends every key
    that passes the prep to the table path (K-B, K-T)."""
    v = ed25519.Ed25519BatchVerifier(chunk_size=32, hot_threshold=hot_threshold,
                                     device=device)
    report = {}
    for name, cases, expected in adversarial_cases():
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

def make_batch(n_keys: int, seed: int, msg_len: int):
    """N_SIGS (pk, sig, msg), key i % n_keys, every 100th R corrupted.  With
    libsodium every message is distinct; the fallback signs one message
    per key (at least 2,048 triples) and tiles them."""
    rng = np.random.default_rng(seed)
    key_seeds = rng.integers(0, 256, size=(n_keys, 32), dtype=np.uint8)
    keys = [sodium.sign_seed_keypair(key_seeds[k].tobytes())
            for k in range(n_keys)]
    n_distinct = N_SIGS if sodium.available() else max(2048, n_keys)
    msgs = rng.integers(0, 256, size=(n_distinct, msg_len), dtype=np.uint8)
    triples = []
    for t in range(n_distinct):
        pk, sk = keys[t % n_keys]
        m = msgs[t].tobytes()
        triples.append((pk, sodium.sign_detached(m, sk), m))
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


def hold_card() -> None:
    """Keep the card busy for about 50 ms, so that the calls enqueued
    behind it run back to back: events then time the card's work, not
    the rate at which the host enqueues launches (a kernel of tens of
    microseconds is shorter than its wrapper's host time)."""
    torch.cuda._sleep(100_000_000)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over `reps` calls (CUDA events),
    after one untimed call; see hold_card.  A plain version that syncs
    inside runs at the host's pace all the same."""
    fn()
    torch.cuda.synchronize()
    hold_card()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def two_stream_ms(dev, launch, n: int, reps: int) -> float:
    """Mean ms of one chunk of n rows split into two contiguous halves,
    launch(lo, hi) each on its own stream of `dev`, forked from and joined
    back to the current stream: the sharded forms' step with two shards on
    one card (see cuda_ms)."""
    shards = Shards([dev, dev])

    def step():
        for k, (lo, hi) in enumerate(parts(n, 2)):
            with shards.on(k):
                launch(lo, hi)
        for k in range(2):
            shards.join(k)

    return cuda_ms(step, reps)


def bound_ms(imads: float, nbytes: float):
    ops_ms = imads / IMAD_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


# multiply / square counts of the kernels' own code (csrc/verify.cuh)
def kg_imads() -> int:
    """K-G per signature, the products of its quad body: table (dbl, 3
    to_pre, add_pre, 3 x (to_pre + 3 x (add_pre + to_pre)); the identity's
    entry takes none), 127 x (2 dbl + add_pre), encode (invert + 2 mul).
    Each product is counted once: the exchanges between a quad's lanes and
    the copies of the invert and of the operand sums that every lane runs
    in step are the design's, not the work's."""
    sq = 4 + 127 * 8 + 254
    mul = (4 + 3 + 8 + 3 * (1 + 3 * 9)) + 127 * (8 + 8) + (11 + 2)
    return sq * SQ_IMADS + mul * MUL_IMADS


def kt_imads() -> int:
    """K-T per signature, the work: 128 precomputed adds, encode.  Its
    design, a pair of lanes a signature, runs one complete add more to join
    the two lanes' halves (9 products, under 1%), and both lanes run the
    encode's invert in step: the bound counts the work, not the design."""
    return 254 * SQ_IMADS + (128 * 8 + 13) * MUL_IMADS


def kb_imads() -> int:
    """K-B per key, the work, each product once: x*y, the chain of 4
    doublings between windows (252), and per window the entry of 16^w A
    and 14 x (precomputed add + its entry); the identity's entry takes
    none.  The design runs just that: the chain once a key, on one warp.
    (The reference's full add takes 9 products where the precomputed add
    the kernel runs takes 8: 127 a window, not 142.)"""
    dbl = 4 * (tables.NWIN - 1)
    return dbl * 4 * SQ_IMADS + (1 + dbl * 4 + tables.NWIN * (1 + 14 * 9)) * MUL_IMADS


def kw_bytes(n: int) -> int:
    """K-W's bytes for n signatures: 127 int32 windows, a key's 96 bytes
    and R's 32 read, one verdict byte written, and the count's 4 bytes."""
    return n * (127 * 4 + 96 + 32 + 1) + 4


KERNEL_WRAPPERS = {"K-B": tables.build_tables_into,
                   "K-T": tables.verify_tables,
                   "K-G": ed25519.verify_generic,
                   "K-QF": quorum.flags_kernel,
                   "K-QC": quorum.compact_kernel,
                   "K-W": ed25519.verify_windows}


def union_ms(intervals) -> float:
    """Length of the union of (start, end) intervals: the time at least one
    kernel ran, where launches on several streams overlap."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def drive(call) -> dict:
    """One main-path call: launch counts set to 0 just before and read just
    after, its wall seconds, and the device time of the kernels it launched
    (CUDA events recorded around each launch): their sum, and on a machine
    with one card the union of their spans (busy_ms), which counts the
    time two streams' launches overlap once."""
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    origin = None
    if torch.cuda.is_available() and torch.cuda.device_count() == 1:
        origin = torch.cuda.Event(enable_timing=True)
        origin.record()
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
    busy_ms = None if origin is None else union_ms(
        (origin.elapsed_time(start), origin.elapsed_time(end))
        for _, start, end in events)
    return {"verdicts": verdicts, "seconds": seconds, "kernel_ms": kernel_ms,
            "busy_ms": busy_ms,
            "launches": {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}}


def call_report(run: dict) -> dict:
    """A drive() result's seconds, launches and kernel time; busy_share is
    the kernels' summed device time over the call's wall time,
    busy_union_share the union of their spans over it (the card's busy
    share where launches on several streams overlap)."""
    wall_ms = 1e3 * run["seconds"]
    return {"seconds": run["seconds"], "launches": run["launches"],
            "kernel_ms": run["kernel_ms"],
            "busy_share": run["kernel_ms"] / wall_ms,
            "busy_ms": run["busy_ms"],
            "busy_union_share": None if run["busy_ms"] is None
            else run["busy_ms"] / wall_ms}


def report(run: dict) -> dict:
    """What a verify main-path line prints of a drive() result: its rate
    and call_report's numbers."""
    return {"sigs_per_s": N_SIGS / run["seconds"], **call_report(run)}


# -- the signature seam: catchup replay's verdict half -----------------------

# bench.py's replay archive (build_archive): 120 accounts, every 4th with an
# extra ed25519 signer that co-signs its transactions, 40 payments a ledger
SEAM_ACCOUNTS, SEAM_MULTISIG_EVERY, SEAM_TXS_PER_LEDGER = 120, 4, 40
SEAM_LEDGERS = 1024                 # about 40,960 envelopes, 51,200 signatures
SEAM_CHUNK = 2048                   # PreverifyPipeline's chunk (catchup.py:131)
SEAM_DISTINCT = 4096                # envelopes signed where libsodium is missing
SEAM_PASSPHRASE = "chip smoke seam net"
SEAM_PATHS = (("K-G", 1 << 62), ("K-B+K-T", 4))


def seam_envelopes(n_ledgers: int = SEAM_LEDGERS,
                   n_distinct: int = SEAM_DISTINCT):
    """Transaction envelopes shaped like bench.py's replay archive, each
    v1 with one native payment, signed over the hash of its
    TransactionSignaturePayload (TransactionFrame.content_hash), in XDR
    bytes; every 100th signature in order is corrupted.  With libsodium
    every envelope is signed; without, the first n_distinct are (the
    pure-Python signer is slow) and tiled.  Returns the envelopes, each
    account's (signers, needed weight) by key, and the fixed verdict of
    each signature in order (False where corrupted)."""
    nid = sha256(SEAM_PASSPHRASE.encode())
    rng = random.Random(11)
    masters = [sodium.sign_seed_keypair(
        bytes([1 + (i % 250)]) * 31 + bytes([i // 250]))
        for i in range(SEAM_ACCOUNTS)]
    extras = {i: sodium.sign_seed_keypair(
        bytes([200 + (i % 50)]) * 31 + bytes([i // 50]))
        for i in range(0, SEAM_ACCOUNTS, SEAM_MULTISIG_EVERY)}
    accounts = {}
    for i, (pk, _) in enumerate(masters):
        # the account's signers, then its master key (check_account_signature
        # order); a co-signed account asks for both signatures
        signers = [X.Signer(key=X.SignerKey.ed25519(extras[i][0]), weight=1)] \
            if i in extras else []
        signers.append(X.Signer(key=X.SignerKey.ed25519(pk), weight=1))
        accounts[pk] = (signers, len(signers))
    seqs = [(i + 2) << 32 for i in range(SEAM_ACCOUNTS)]
    n_total = n_ledgers * SEAM_TXS_PER_LEDGER
    n_signed = n_total if sodium.available() else min(n_total, n_distinct)
    distinct = []          # (envelope bytes, tx, [(hint, signature)])
    for _ in range(n_signed):
        i = rng.randrange(SEAM_ACCOUNTS)
        dest = masters[rng.randrange(SEAM_ACCOUNTS)][0]
        seqs[i] += 1
        tx = X.Transaction(
            sourceAccount=X.MuxedAccount.ed25519(masters[i][0]), fee=100,
            seqNum=seqs[i], cond=X.Preconditions.none(), memo=X.Memo.none(),
            operations=[X.Operation(body=X.OperationBody.paymentOp(X.PaymentOp(
                destination=X.muxed_from_account_id(X.AccountID.ed25519(dest)),
                asset=X.Asset.native(), amount=1000 + rng.randrange(10 ** 6))))])
        h = content_hash(nid, tx)
        sigs = [(pk[28:32], sodium.sign_detached(h, sk))
                for pk, sk in [masters[i]] + ([extras[i]] if i in extras else [])]
        distinct.append((_envelope(tx, sigs), tx, sigs))
    envelopes, fixed = [], []
    for k in range(n_total):
        env, tx, sigs = distinct[k % n_signed]
        bad = [(len(fixed) + j) % 100 == 99 for j in range(len(sigs))]
        fixed += [not b for b in bad]
        if any(bad):
            env = _envelope(tx, [(hint, bytes([sig[0] ^ 1]) + sig[1:] if b
                                  else sig) for (hint, sig), b in zip(sigs, bad)])
        envelopes.append(env)
    return envelopes, accounts, fixed


def content_hash(nid: bytes, tx) -> bytes:
    """The hash each signature signs: SHA-256 of the transaction's
    TransactionSignaturePayload (TransactionFrame.content_hash)."""
    return sha256(X.TransactionSignaturePayload(
        networkId=nid,
        taggedTransaction=X.TransactionSignaturePayloadTaggedTransaction.tx(
            tx)).to_xdr())


def _envelope(tx, sigs) -> bytes:
    return X.TransactionEnvelope.v1(X.TransactionV1Envelope(
        tx=tx, signatures=[X.DecoratedSignature(hint=hint, signature=sig)
                           for hint, sig in sigs])).to_xdr()


def seam_decode(envelopes, accounts):
    """Replay's first half: decode each envelope, hash its signature
    payload, and pair each signature with the source account's signer
    whose hint it carries.  Returns [(hash, signatures, source key)] and
    the (pk, sig, hash) pairs, in signature order."""
    nid = sha256(SEAM_PASSPHRASE.encode())
    decoded, pairs = [], []
    for raw in envelopes:
        env = X.TransactionEnvelope.from_xdr(raw)
        tx = env.value.tx
        h = content_hash(nid, tx)
        source = tx.sourceAccount.value
        hints = {sg.key.value[28:32]: sg.key.value for sg in accounts[source][0]}
        for d in env.value.signatures:
            pairs.append((hints[d.hint], d.signature, h))
        decoded.append((h, env.value.signatures, source))
    return decoded, pairs


SEAM_COUNTERS = ("accel.ed25519.table-sigs", "accel.ed25519.generic-sigs",
                 "accel.ed25519.rejected-prep", "crypto.verify.cache-hit",
                 "crypto.verify.recompute")


def seam_path(decoded, pairs, accounts, oracle, hot: int, device=None) -> dict:
    """One run of the seam on one verify path: verify_batch_async as
    catchup replay calls it (PreverifyPipeline._enqueue_group), the verify
    cache seeded as replay seeds it (_seed_group), then each envelope's
    SignatureChecker answered from that cache.  Raises unless every
    verdict and every envelope's result is the oracle's, no verdict was
    recomputed, every ed25519 check hit the cache and every signature was
    counted by the verifier."""
    n = len(pairs)
    ed25519._verifiers.clear()      # a fresh verifier, as a new replay has
    reg = registry()
    before = {c: reg.counter(c).value for c in SEAM_COUNTERS}
    pks = [p for p, _, _ in pairs]
    sigs = [g for _, g, _ in pairs]
    msgs = [h for _, _, h in pairs]
    run = drive(lambda: ed25519.verify_batch_async(
        pks, sigs, msgs, chunk_size=SEAM_CHUNK, tail_floor=SEAM_CHUNK,
        hot_threshold=hot, device=device)())
    verdicts = run["verdicts"]
    bad = int((verdicts != np.asarray(oracle)).sum())
    if bad:
        raise AssertionError(f"seam: {bad} verdicts differ from the oracle")
    t0 = time.perf_counter()
    crypto_keys.clear_verify_cache()
    crypto_keys.seed_verify_cache(
        (pks[i], sigs[i], msgs[i], bool(verdicts[i])) for i in range(n))
    seed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = []
    for h, dsigs, source in decoded:
        signers, weight = accounts[source]
        checker = SignatureChecker(23, h, dsigs)     # protocol 23
        results.append((checker.check_signature(signers, weight),
                        checker.check_all_signatures_used()))
    check_s = time.perf_counter() - t0
    crypto_keys.clear_verify_cache()
    delta = {c: reg.counter(c).value - before[c] for c in SEAM_COUNTERS}
    want, at = [], 0
    for _, dsigs, _ in decoded:
        ok = all(oracle[at:at + len(dsigs)])
        want.append((ok, ok))
        at += len(dsigs)
    mismatches = sum(1 for a, b in zip(results, want) if a != b)
    counted = delta["accel.ed25519.table-sigs"] \
        + delta["accel.ed25519.generic-sigs"] \
        + delta["accel.ed25519.rejected-prep"]
    uses = {}
    for pk in pks:
        uses[pk] = uses.get(pk, 0) + 1
    cold = sum(1 for pk in pks if uses[pk] < hot)
    report = {
        "hot_threshold": hot, "signatures": n, "envelopes": len(decoded),
        "accepted_envelopes": sum(1 for ok, _ in results if ok),
        "envelope_mismatches": mismatches, "counters": delta,
        "verify": call_report(run), "verify_sigs_per_s": n / run["seconds"],
        "seed_s": seed_s, "seed_sigs_per_s": n / seed_s,
        "check_s": check_s, "check_sigs_per_s": n / check_s}
    if mismatches or delta["crypto.verify.recompute"] \
            or delta["crypto.verify.cache-hit"] != n or counted != n \
            or delta["accel.ed25519.generic-sigs"] != cold:
        raise AssertionError(f"seam checks failed: {report}")
    return report


def signature_seam(n_ledgers: int = SEAM_LEDGERS, device=None) -> dict:
    """The signature-seam phase: envelopes built, then decoded and hashed
    once, then both verify paths (K-G at the replay default hot_threshold
    1 << 62, K-B + K-T at the bench's 4) through seam_path.  Each path's
    launches are counted from 0 around its verify call; on the card each
    path must have run on its kernels alone."""
    t0 = time.perf_counter()
    envelopes, accounts, fixed = seam_envelopes(n_ledgers)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded, pairs = seam_decode(envelopes, accounts)
    decode_s = time.perf_counter() - t0
    if len(pairs) != len(fixed):
        raise AssertionError(f"{len(pairs)} pairs for {len(fixed)} signatures")
    oracle = fixed
    if sodium.available():
        oracle = [sodium.verify_detached(g, h, p) for p, g, h in pairs]
        if oracle != fixed:
            raise AssertionError("libsodium disagrees with the fixed verdicts")
    report = {"phase": "signature-seam", "signer": signer_name(),
              "oracle": "libsodium" if sodium.available() else "fixed verdicts",
              "cxdr": xdr_codec._cxdr is not None, "ledgers": n_ledgers,
              "envelopes": len(envelopes), "signatures": len(pairs),
              "corrupted": fixed.count(False), "build_s": build_s,
              "decode_hash_s": decode_s,
              "decode_hash_sigs_per_s": len(pairs) / decode_s}
    on_card = device is None or torch.device(device).type == "cuda"
    for name, hot in SEAM_PATHS:
        path = seam_path(decoded, pairs, accounts, oracle, hot, device)
        # the verdict path's wall time, decode to checks, and the share of
        # it the kernels took (their summed CUDA-event time)
        path["path_s"] = decode_s + path["verify"]["seconds"] \
            + path["seed_s"] + path["check_s"]
        path["kernel_share"] = path["verify"]["kernel_ms"] / 1e3 \
            / path["path_s"]
        n = path["verify"]["launches"]
        generic = path["counters"]["accel.ed25519.generic-sigs"]
        if name == "K-G":
            ran = n["K-G"] >= 1 and n["K-B"] == n["K-T"] == 0
        else:
            ran = n["K-B"] >= 1 and n["K-T"] >= 1 \
                and (n["K-G"] >= 1) == (generic > 0)
        if on_card and not ran:
            raise AssertionError(f"seam {name}: launches {n}")
        report[name] = path
    return report


# -- quorum intersection -----------------------------------------------------

def bound_from(ops_s: float, nbytes: float):
    """(bound ms, what bounds it): the larger of the operations' time and
    the bytes over the memory rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_s * 1e3, "operations") if ops_s * 1e3 >= bytes_ms \
        else (bytes_ms, "bytes")


class _Recorded(Exception):
    """Ends a recording walk once it has the segment it wanted."""


def record_segments(qmap, dev, stop=lambda args, capacity: False):
    """Walk qmap's check on `dev` with the plain segment_step, recording
    each segment's arguments (real frontier states) and capacity (None:
    the frontier's rows) until stop(arguments, capacity) holds; returns
    the (arguments, capacity) pairs."""
    seen = []

    def record(*args, capacity=None, **kw):
        seen.append((args, capacity))
        if stop(args, capacity):
            raise _Recorded
        return quorum.segment_step_plain(*args, capacity=capacity)

    real = quorum.segment_step
    quorum.segment_step = record
    try:
        quorum.CudaQuorumIntersectionChecker(qmap, device=dev).check()
    except _Recorded:
        pass
    finally:
        quorum.segment_step = real
    return seen


def random_rows(ck, n_rows: int, seed: int) -> torch.Tensor:
    """Child rows of ck's map, each of its own density (some quorums)."""
    rng = np.random.default_rng(seed)
    member = rng.random((n_rows, ck.n)) < rng.uniform(0.2, 1.0, (n_rows, 1))
    words = np.zeros((n_rows, ck.n_words), dtype=np.int64)
    for i in range(ck.n):
        words[:, i // 32] |= member[:, i].astype(np.int64) << (i % 32)
    return torch.from_numpy(words).to(ck.device)


def flags_diff(got, want) -> tuple:
    """(rows whose flags differ, max |difference|) of two flag triples."""
    diff = torch.stack([g.int() - w.int() for g, w in zip(got, want)]).abs()
    return int(diff.amax(0).sum()), int(diff.max())


def segment_diff(args, capacity=None) -> tuple:
    """The CUDA segment_step against the plain one on the same arguments:
    (differing meta entries + rows of frontier'[:count'] + counted witness
    rows, max |difference|, the plain meta)."""
    fk, mk, rk = quorum.segment_step(*args,
                                     tables=quorum.flag_tables(*args[-4:]),
                                     capacity=capacity)
    fp, mp, rp = quorum.segment_step_plain(*args, capacity=capacity)
    mk, mp = mk.cpu(), mp.cpu()
    diffs = [(mk - mp).abs()]
    n = int(mp[2 * quorum.SEG_DEPTHS])
    diffs.append((fk[:n] - fp[:n]).abs().amax(-1).cpu())
    for j in range(quorum.SEG_DEPTHS):
        w = min(int(mp[quorum.SEG_DEPTHS + j]), quorum.WITNESS_CAP)
        diffs.append((rk[j, :w] - rp[j, :w]).abs().amax(-1).cpu())
    bad = sum(int((d > 0).sum()) for d in diffs)
    err = max([int(d.max()) for d in diffs if d.numel()] + [0])
    return bad, err, mp.tolist()


def event_ms(call, kernel: str, reps: int) -> float:
    """Mean CUDA-event time of `kernel`'s launches over `reps` calls of
    call(), after one untimed call; see hold_card."""
    call()
    torch.cuda.synchronize()
    _cuda_build.launch_events = []
    try:
        hold_card()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        times = [s.elapsed_time(e) for k, s, e in _cuda_build.launch_events
                 if k == kernel]
    finally:
        _cuda_build.launch_events = None
    return sum(times) / len(times)


def word_bytes(*tensors) -> int:
    """Bytes of the tensors as 32-bit words: the enumerator's node sets
    are 32-bit words (held in int64 on the card), its thresholds int32."""
    return 4 * sum(t.numel() for t in tensors)


def random_prune_args(ck, n_rows: int) -> tuple:
    """prune_step's arguments for n_rows random child rows of ck's map
    (random_rows, seeded by the map's size), the upper half of its nodes
    remaining and all of them in the scc."""
    rows = random_rows(ck, n_rows, seed=ck.n)
    everyone = (1 << ck.n) - 1
    rem, all_w = (torch.from_numpy(quorum._masks_to_words([m], ck.n_words)[0])
                  .to(ck.device)
                  for m in (everyone >> (ck.n // 2) << (ck.n // 2), everyone))
    return (rows, rem, all_w, *ck._map())


def rows_diff(qmap, dev, n_rows: int, path: str) -> dict:
    """K-QF against the plain prune_step on n_rows random child rows of
    qmap, whose map must take K-QF's path `path`."""
    ck = quorum.CudaQuorumIntersectionChecker(qmap, device=dev)
    if quorum.flags_path(ck.tables) != path:
        raise AssertionError(f"{path} map took K-QF's "
                             f"{quorum.flags_path(ck.tables)} path")
    args = random_prune_args(ck, n_rows)
    bad, err = flags_diff(quorum.prune_step(*args, tables=ck.tables),
                          quorum.prune_step_plain(*args))
    return {"words": ck.n_words, "path": path, "rows": n_rows,
            "smem_bytes": quorum.flags_smem_bytes(ck.tables),
            "mismatches": bad, "max_abs_err": err}


def tallied(call):
    """(call()'s result, the plain versions' popcount tally during it)."""
    quorum.popcount_tally = {"distinct": 0, "per_member": 0}
    try:
        out = call()
        return out, dict(quorum.popcount_tally)
    finally:
        quorum.popcount_tally = None


def quorum_kernels_vs_plain(dev) -> tuple:
    """K-QF and K-QC against their plain versions on the card; returns
    their timing entries at asym7's widest depth (the main path's widest
    launches; for the kernels line) and at 65,536 children."""
    S = quorum.SEG_DEPTHS
    half = QF_ROWS // 2
    t0 = time.perf_counter()
    # asym7's segments up to its widest depth: the one-depth segment from
    # its frontier peak into twice its rows, as main-quorum launches it
    segs7 = record_segments(qmaps.asym_org_qmap(7), dev,
                            lambda a, cap: a[1] == ASYM7_FRONTIER_PEAK)
    wide_seg, wide_cap = segs7[-1]
    if wide_seg[1] != ASYM7_FRONTIER_PEAK or wide_cap != 2 * wide_seg[1] \
            or wide_cap <= quorum.CudaQuorumIntersectionChecker \
            .CAPACITY_BUCKETS[-1]:
        raise AssertionError(f"asym7's walk ended at {wide_seg[1]} rows, "
                             f"capacity {wide_cap}, not its widest depth")
    # a real asym7 depth: the first segment that starts from >= 32,768 rows
    fr, count, bits, rems, active, scc, *tabs = next(
        a for a, _ in segs7 if a[1] >= half)
    del segs7
    ft = quorum.flag_tables(*tabs)
    live = fr[:half]
    children = torch.cat([live, live | bits[0][None]])
    qf_args = (children, rems[0], scc, *tabs)
    got = quorum.prune_step(*qf_args, tables=ft)
    want, popcounts = tallied(lambda: quorum.prune_step_plain(*qf_args))
    qf_bad, qf_err = flags_diff(got, want)
    qf = {"rows_asym7": {"mismatches": qf_bad, "depth_count": int(count),
                         "alive": int(want[0].sum()),
                         "quorums": int(want[1].sum()),
                         "distinct_sets": ft.dims[1] + ft.dims[2],
                         "classes": ft.dims[0],
                         "popcounts": popcounts["distinct"],
                         "popcounts_per_member": popcounts["per_member"]}}
    # two- and seven-word rows (fast path), 9-word rows of a 257-node map
    # (wide path), and a map whose tables exceed shared memory (global)
    for name, qmap, n_rows, path in (
            ("flat40", qmaps.flat_qmap(40, 40), QF_ROWS, "fast"),
            ("flat200", qmaps.flat_qmap(200, 134), QF_ROWS, "fast"),
            ("watched257", qmaps.watched_org_qmap(*WIDE_MAP), QF_ROWS,
             "wide"),
            ("scattered256", qmaps.scattered_qmap(256, 16, seed=3),
             QF_ROWS_GLOBAL, "global")):
        qf[f"rows_{name}"] = entry = rows_diff(qmap, dev, n_rows, path)
        qf_bad += entry["mismatches"]
        qf_err = max(qf_err, entry["max_abs_err"])

    # segments: one asym7 depth (the 65,536-child shape), the widest asym7
    # depth at full width, a full asym6 segment, the split map's witness
    # segment, and a forced overflow
    cap = next(c for c in quorum.CudaQuorumIntersectionChecker.CAPACITY_BUCKETS
               if c >= half << S)
    fr7 = torch.zeros((cap, fr.shape[1]), dtype=torch.int64, device=dev)
    fr7[:half] = live
    one_depth = np.array([True] + [False] * (S - 1))
    seg7 = (fr7, half, bits, rems, one_depth, scc, *tabs)
    seg6 = record_segments(qmaps.asym_org_qmap(6), dev,
                           lambda a, cap: a[1] >= 4096)[-1][0]
    split = [a for a, _ in record_segments(qmaps.org_qmap(*SPLIT_MAP), dev)
             if any(quorum.segment_step_plain(*a)[1][S:2 * S].tolist())][0]
    fr6, count6 = seg6[0], seg6[1]
    overflow = None
    for c in (8 * count6, 4 * count6, 2 * count6, count6):
        small = (fr6[:c] if c <= len(fr6) else torch.cat(
            [fr6, fr6.new_zeros((c - len(fr6), fr6.shape[1]))]),) + seg6[1:]
        ovf = int(quorum.segment_step_plain(*small)[1][-1])
        if ovf >= 0:
            overflow = small
            if ovf >= 1:
                break
    qc, qc_bad, qc_err = {}, 0, 0
    for name, args, cap in (("asym7_depth", seg7, None),
                            ("asym7_widest", wide_seg, wide_cap),
                            ("asym6", seg6, None), ("split", split, None),
                            ("overflow", overflow, None)):
        bad, err, meta = segment_diff(args, cap)
        qc[name] = {"count": int(args[1]), "capacity": cap or len(args[0]),
                    "mismatches": bad, "meta": meta}
        qc_bad, qc_err = qc_bad + bad, max(qc_err, err)
    if qc["split"]["meta"][S:2 * S] == [0] * S or \
            qc["overflow"]["meta"][-1] < 0:
        raise AssertionError(f"the witness or overflow segment did not "
                             f"witness or overflow: {qc}")
    emit({"phase": "quorum-kernels-vs-plain", "K-QF": qf, "K-QC": qc,
          "seconds": time.perf_counter() - t0})
    if qf_bad or qc_bad:
        raise AssertionError("a quorum kernel disagrees with its plain version")

    # times at two shapes: 65,536 children of 32,768 rows (the shape of the
    # earlier measurements), and the widest depth, 2 x 5,824,512 children
    # (the main path's widest)
    wfr, wcount, wbits, wrems, _, wscc = wide_seg[:6]
    wide_children = torch.cat([wfr[:wcount], wfr[:wcount] | wbits[0][None]])
    wide_qf = (wide_children, wrems[0], wscc, *tabs)
    wide_flags, wide_pop = tallied(lambda: quorum.prune_step_plain(*wide_qf))
    timing = {}
    for shape, kids, qf_in, seg, cap, flags, pops, reps in (
            ("65536", children, qf_args, seg7, len(fr7), want, popcounts, 20),
            ("widest", wide_children, wide_qf, wide_seg, wide_cap,
             wide_flags, wide_pop, 5)):
        kept, n_src = int(flags[0].sum()), seg[1]

        # the depth's two launches as segment_step makes them, without its
        # closing sync (event_ms's held card then times the kernels, not
        # the host's launch gaps)
        def depth(seg=seg, cap=cap):
            return quorum.enqueue_segment(*seg[:6], ft, cap)

        t = {"K-QF": {
            "ms": event_ms(lambda: quorum.prune_step(*qf_in, tables=ft),
                           "K-QF", reps),
            "in_segment_ms": event_ms(depth, "K-QF", reps),
            "plain_ms": cuda_ms(lambda: quorum.prune_step_plain(*qf_in), 1),
            # the popcounts of each distinct set at each pass (asym7's one
            # class is in every non-empty row, so K-QF issues just these);
            # rows read once, three flag bytes written, the map's tables,
            # remaining and scc
            "bound": bound_from(pops["distinct"] / POPC_PER_S,
                                word_bytes(kids, ft.blob, qf_in[1],
                                           qf_in[2]) + 3 * len(kids)),
            "max_abs_err": qf_err, "library_ms": None}, "K-QC": {
            "ms": event_ms(depth, "K-QC", reps),
            "plain_ms": cuda_ms(lambda: quorum.compact_plain(kids, *flags), 3),
            # three flag bytes a child, the source rows read once and the
            # kept rows written (32-bit words; the card holds them as
            # int64, so the kernel moves twice these row bytes); the scans'
            # additions at the multiply-add rate
            "bound": bound_from(4 * len(kids) / IMAD_PER_S,
                                3 * len(kids)
                                + 4 * (n_src + kept) * kids.shape[1]),
            "max_abs_err": qc_err,
            "library_ms": cuda_ms(lambda: kids[flags[0]], 5)}}
        if shape == "65536":
            t["K-QF"]["ms_2_streams"] = two_stream_ms(
                dev, lambda lo, hi: quorum.prune_step(
                    children[lo:hi], *qf_args[1:], tables=ft), QF_ROWS, 20)
        timing[shape] = t
    del wide_flags, wide_children, wide_qf, wide_seg
    emit({"phase": "quorum-kernel-times",
          "widest_depth": {"count": wcount, "children": 2 * wcount,
                           "popcounts": wide_pop["distinct"]},
          **{shape: {k: {key: (v["bound"] if key == "bound" else v[key])
                         for key in v if key != "max_abs_err"}
                     for k, v in t.items()}
             for shape, t in timing.items()}})
    return timing["widest"], timing["65536"]


def check_cuda(qmap):
    """What check_intersection_cuda(qmap) does, with no device argument,
    keeping the checker so that its stats can be read."""
    ck = quorum.CudaQuorumIntersectionChecker(qmap)
    return ck.check(), ck.stats


def split_check(qmap, sides, max_quorums, phase: str, name: str) -> None:
    """A splitting map through check_intersection_cuda with no device
    argument: its split must be the JAX package's (`sides`, as indices of
    testutils.nid) and both sides quorums to the CPU oracle."""
    run = drive(lambda: quorum.check_intersection_cuda(qmap))
    res = run["verdicts"]
    want = tuple([qmaps.nid(i) for i in side] for side in sides)
    oracle = QuorumIntersectionChecker(qmap)
    a, b = ([sum(1 << oracle.index[v] for v in side) for side in res.split]
            if res.split else (0, 0))
    accepted = oracle.is_quorum(a) and oracle.is_quorum(b) and not a & b
    emit({"phase": phase, "map": name, "nodes": res.node_count,
          "intersects": res.intersects,
          "split_sizes": [len(s) for s in res.split or ()],
          "split_equals_jax": res.split == want, "oracle_accepts": accepted,
          "max_quorums_found": res.max_quorums_found, **call_report(run)})
    if res.intersects or res.split != want or not accepted \
            or res.max_quorums_found != max_quorums:
        raise AssertionError(f"{name}: {res}")


def quorum_main_paths() -> dict:
    """The checker on the default card, with no device argument: asym7,
    the split map (through check_intersection_cuda), asym5 on tiny
    buckets, and the 257-node map and its split form.  Returns asym7's
    launches."""
    run = drive(lambda: check_cuda(qmaps.asym_org_qmap(7)))
    res, stats = run["verdicts"]
    launches = run["launches"]
    emit({"phase": "main-quorum", "map": "asym7", "nodes": res.node_count,
          "intersects": res.intersects,
          "max_quorums_found": res.max_quorums_found,
          "frontier_peak": stats["frontier_peak"], **call_report(run)})
    # one K-QF and one K-QC a depth, the depths the reference chunks too
    if not res.intersects or res.max_quorums_found != ASYM7_MAX_QUORUMS \
            or stats["frontier_peak"] != ASYM7_FRONTIER_PEAK \
            or launches["K-QC"] < 1 or launches["K-QF"] != launches["K-QC"]:
        raise AssertionError(f"asym7: {res}, {stats}, launches {launches}")
    main_launches = launches

    split_check(qmaps.org_qmap(*SPLIT_MAP), SPLIT_SIDES, SPLIT_MAX_QUORUMS,
                "main-quorum-split", "org_qmap%s" % (SPLIT_MAP,))

    # asym5 on buckets (8, 16): the depths the reference runs host-chunked
    # run as one-depth segments past the top bucket; no frontier comes home
    # (no _prune chunk, no CUDA tensor through _host)
    checker = quorum.CudaQuorumIntersectionChecker
    seen = {"chunked_on_card": 0, "downloads": 0, "prune_calls": 0}
    real = quorum.segment_step, quorum._host, checker._prune

    def step(*args, capacity=None, **kw):
        seen["chunked_on_card"] += capacity is not None and capacity > 16
        return real[0](*args, capacity=capacity, **kw)

    def host(a):
        seen["downloads"] += isinstance(a, torch.Tensor) and a.is_cuda
        return real[1](a)

    def prune(self, *args):
        seen["prune_calls"] += 1
        return real[2](self, *args)

    buckets = checker.CAPACITY_BUCKETS
    checker.CAPACITY_BUCKETS = (8, 16)
    # made first: its map's upload goes through _host too
    ck = checker(qmaps.asym_org_qmap(5))
    quorum.segment_step, quorum._host, checker._prune = step, host, prune
    try:
        run = drive(lambda: (ck.check(), ck.stats))
    finally:
        checker.CAPACITY_BUCKETS = buckets
        quorum.segment_step, quorum._host, checker._prune = real
    res, stats = run["verdicts"]
    emit({"phase": "main-quorum-ladder", "map": "asym5", "buckets": [8, 16],
          "intersects": res.intersects,
          "max_quorums_found": res.max_quorums_found,
          "frontier_peak": stats["frontier_peak"], **seen,
          **call_report(run)})
    if not res.intersects or res.max_quorums_found != ASYM5_MAX_QUORUMS \
            or stats["frontier_peak"] != LADDER_FRONTIER_PEAK \
            or seen["chunked_on_card"] < 1 or seen["downloads"] \
            or seen["prune_calls"]:
        raise AssertionError(f"asym5 ladder: {res}, {stats}, {seen}")

    # more than 256 nodes: rows of 9 words on K-QF's wide path
    qmap = qmaps.watched_org_qmap(*WIDE_MAP)
    run = drive(lambda: check_cuda(qmap))
    res, stats = run["verdicts"]
    path = quorum.flags_path(
        quorum.CudaQuorumIntersectionChecker(qmap).tables)
    emit({"phase": "main-quorum-wide",
          "map": "watched_org_qmap%s" % (WIDE_MAP,), "nodes": res.node_count,
          "main_scc_size": res.main_scc_size, "k_qf_path": path,
          "intersects": res.intersects,
          "max_quorums_found": res.max_quorums_found,
          "frontier_peak": stats["frontier_peak"], **call_report(run)})
    if not res.intersects or res.node_count != 257 or path != "wide" \
            or res.max_quorums_found != WIDE_MAX_QUORUMS \
            or stats["frontier_peak"] != WIDE_FRONTIER_PEAK \
            or run["launches"]["K-QF"] < 1:
        raise AssertionError(f"257-node map: {res}, {stats}, {path}")
    split_check(qmaps.watched_org_qmap(*WIDE_SPLIT_MAP), WIDE_SPLIT_SIDES,
                WIDE_SPLIT_MAX_QUORUMS, "main-quorum-wide-split",
                "watched_org_qmap%s" % (WIDE_SPLIT_MAP,))
    return main_launches


# -- the graft entry and the multi-card forms --------------------------------

def graft_entry_phase(kw_args) -> dict:
    """K-W against its plain version on the cold path's 8,192 signatures
    (as they are, with every 100th R corrupted at another offset, and with
    two windows outside [0, 16), which K-W rejects and the plain version
    refuses), its fused count, its times; then the graft entry's step
    driven as a main path.  Returns K-W's timing entry."""
    windows, keys, r = kw_args
    n = windows.shape[1]
    got = ed25519.verify_windows(*kw_args)
    want = ed25519.verify_windows_plain(*kw_args)
    bad = int((got != want).sum())
    r2 = r.clone()
    r2[::100, 0] ^= 1
    got2 = ed25519.verify_windows(windows, keys, r2)
    want2 = ed25519.verify_windows_plain(windows, keys, r2)
    bad += int((got2 != want2).sum())
    out_of_range = windows.clone()
    out_of_range[5, 3], out_of_range[7, 9] = 16, -1
    got3 = ed25519.verify_windows(out_of_range, keys, r)
    rejects = not bool(got3[3]) and not bool(got3[9])
    keep = torch.ones(n, dtype=torch.bool, device=windows.device)
    keep[[3, 9]] = False
    bad += int((got3[keep] != want[keep]).sum())
    count = torch.zeros(1, dtype=torch.int32, device=windows.device)
    fused = ed25519.verify_windows(*kw_args, count=count)
    fused_count = int(count.item())
    count_ok = fused_count == int(fused.sum()) == int(want.sum())

    small = (windows[:, :8].contiguous(), keys[:8], r[:8])
    timing = {
        "ms": cuda_ms(lambda: ed25519.verify_windows(*kw_args), 5),
        "ms_fused_count": cuda_ms(
            lambda: ed25519.verify_windows(*kw_args, count=count), 5),
        "ms_8": cuda_ms(lambda: ed25519.verify_windows(*small), 20),
        "plain_ms": cuda_ms(lambda: ed25519.verify_windows_plain(*kw_args), 1),
        "plain_ms_8": cuda_ms(lambda: ed25519.verify_windows_plain(*small), 2),
        "bound": bound_ms(n * kg_imads(), kw_bytes(n)),
        "bound_8": bound_ms(8 * kg_imads(), kw_bytes(8)),
        "max_abs_err": int((got.int() - want.int()).abs().max())}

    # the graft entry's step, through the entry a user calls
    def entry_call():
        fn, args = graft_entry.entry()
        return fn(*args).cpu(), args

    run = drive(entry_call)
    verdicts, args = run["verdicts"]
    plain = ed25519.verify_windows_plain(*args).cpu()
    emit({"phase": "graft-entry", "signatures": n, "mismatches": bad,
          "rejects_windows_out_of_range": rejects,
          "accepted": int(want.sum()), "accepted_r_corrupted": int(want2.sum()),
          "fused_count": fused_count, "fused_count_equals_sum": count_ok,
          "entry_verdicts": verdicts.tolist(),
          "entry_equals_plain": bool((verdicts == plain).all()),
          "entry_launches": run["launches"], "entry_seconds": run["seconds"],
          "ms": timing["ms"], "ms_fused_count": timing["ms_fused_count"],
          "ms_8": timing["ms_8"], "plain_ms": timing["plain_ms"],
          "plain_ms_8": timing["plain_ms_8"], "bound_ms": timing["bound"][0],
          "bound_ms_8": timing["bound_8"][0], "bound_by": timing["bound"][1],
          "imads_per_sig": kg_imads(), "bytes": kw_bytes(n)})
    if bad or not rejects or not count_ok or not bool(verdicts.all()) \
            or not bool((verdicts == plain).all()) \
            or run["launches"]["K-W"] != 1:
        raise AssertionError("K-W disagrees with its plain version, or the "
                             "graft entry did not run on it")
    timing["launches"] = run["launches"]["K-W"]
    return timing


def multi_gpu_phase(dev, hot, cold, timing, qf_65536) -> None:
    """The multi-card forms, as shards of `dev`, so that one card
    suffices: dryrun_multigpu(4), verify_batch on the cold and hot inputs
    with devices=[dev, dev], asym5 and the split map through the sharded
    quorum checker; and the kernels' times with a chunk split over two
    streams (K-G's and K-T's from `timing`, K-QF's at 65,536 children)."""
    cards = torch.cuda.device_count()
    emit({"phase": "multi-gpu-kernel-times", "device_count": cards,
          "shards": 2, **{k: {key: t[key] for key in ("ms", "ms_2_streams")}
                          for k, t in (("K-G", timing["K-G"]),
                                       ("K-T", timing["K-T"]),
                                       ("K-QF", qf_65536))}})
    run = drive(lambda: graft_entry.dryrun_multigpu(4))
    summary = run["verdicts"]
    emit({"phase": "multi-gpu-dryrun", "device_count": cards,
          **summary, **call_report(run)})
    if run["launches"]["K-W"] != 4 or run["launches"]["K-QF"] < 1:
        raise AssertionError(f"dryrun_multigpu(4): launches {run['launches']}")

    shards = [dev, dev]
    expect = N_SIGS - N_SIGS // 100                   # 64,881
    out = {"phase": "multi-gpu-verify", "device_count": cards,
           "shards": len(shards)}
    for name, batch, chunk, thr, kernel, chunks in (
            ("cold", cold, COLD_CHUNK, 1 << 62, "K-G", N_SIGS // COLD_CHUNK),
            ("hot", hot, HOT_CHUNK, 4, "K-T", N_SIGS // HOT_CHUNK)):
        def call():
            return ed25519.verify_batch(*batch, chunk_size=chunk,
                                        hot_threshold=thr, devices=shards)
        first, steady = drive(call), drive(call)
        out[name] = {"accepted": [int(first["verdicts"].sum()),
                                  int(steady["verdicts"].sum())],
                     "first_call": report(first), "steady": report(steady)}
        # every chunk splits into two non-empty parts: each shard launched
        if out[name]["accepted"] != [expect, expect] or \
                steady["launches"][kernel] != len(shards) * chunks:
            emit(out)
            raise AssertionError(f"sharded {name} path: {out[name]}")
    emit(out)

    split_want = tuple([qmaps.nid(i) for i in side] for side in SPLIT_SIDES)
    results = {}
    for name, qmap in (("asym5", qmaps.asym_org_qmap(5)),
                       ("split", qmaps.org_qmap(*SPLIT_MAP))):
        run = drive(lambda: quorum.check_intersection_cuda(qmap,
                                                           devices=shards))
        res = run["verdicts"]
        results[name] = {"intersects": res.intersects,
                         "max_quorums_found": res.max_quorums_found,
                         "split_equals_jax": res.split == split_want,
                         **call_report(run)}
    emit({"phase": "multi-gpu-quorum", "device_count": cards,
          "shards": len(shards), **results})
    if not results["asym5"]["intersects"] \
            or results["asym5"]["max_quorums_found"] != ASYM5_MAX_QUORUMS \
            or results["split"]["intersects"] \
            or not results["split"]["split_equals_jax"] \
            or results["split"]["max_quorums_found"] != SPLIT_MAX_QUORUMS:
        raise AssertionError(f"sharded quorum checker: {results}")


# the kernels on groups of lanes (quads; K-T pairs), and the stack frame
# each must stay below
QUAD_KERNELS = {"verify_generic_kernel": TABLE_BYTES,
                "verify_windows_kernel": TABLE_BYTES,
                "verify_tables_kernel": POINT_BYTES,
                "build_tables_kernel": POINT_BYTES}


def check_quad_kernels(ptxas: dict) -> None:
    """The kernels on groups of lanes keep their points in registers and
    their tables in shared memory: ptxas must report each of K-G, K-W, K-T
    and K-B with no spills, and with no stack frame that could hold K-G's
    and K-W's 16-entry table or one of K-T's and K-B's points."""
    quad = {name: (v, QUAD_KERNELS[kernel]) for name, v in ptxas.items()
            for kernel in QUAD_KERNELS if kernel in name}
    if len(quad) != len(QUAD_KERNELS) or any(
            v["spill_stores"] or v["spill_loads"] or v["stack"] >= limit
            for v, limit in quad.values()):
        raise AssertionError(f"K-G / K-W / K-T / K-B missing, spilling or "
                             f"holding a table or point on the stack: {quad}")


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
    check_quad_kernels(ptxas)

    t0 = time.perf_counter()
    hot = make_batch(HOT_KEYS, seed=7, msg_len=120)
    cold = make_batch(COLD_KEYS, seed=8, msg_len=120)
    emit({"phase": "inputs", "signer": signer_name(),
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
    # a ragged n (the last warp's quads past n store nothing) and the
    # admission chunk, against the plain version on the same rows
    kg_sub = {}
    for m in (RAGGED_N, ADMISSION_CHUNK):
        sub = tuple(a[:m] for a in kg_args[:3]) + (keys, kg_args[4][:m])
        kg_sub[m] = sub
        kg_bad += int((ed25519.verify_generic(*sub)
                       != ed25519.verify_forward_raw(*sub)).sum())
    # K-W's inputs: the same signatures, windows made on the host from the
    # same s and h bytes, each signature's key row
    kw_args = (torch.from_numpy(ed25519._windows_msb_first(
        s[:COLD_CHUNK].cpu().numpy(), h[:COLD_CHUNK].cpu().numpy())).to(dev),
        keys[kidx[:COLD_CHUNK].long()].contiguous(), r[:COLD_CHUNK])
    timing["K-G"] = {
        "ms": cuda_ms(lambda: ed25519.verify_generic(*kg_args), 5),
        "ms_2048": cuda_ms(
            lambda: ed25519.verify_generic(*kg_sub[ADMISSION_CHUNK]), 10),
        "bound_2048": bound_ms(ADMISSION_CHUNK * kg_imads(),
                               ADMISSION_CHUNK * (96 + 4 + 1) + keys.numel()),
        "ms_2_streams": two_stream_ms(dev, lambda lo, hi: ed25519.verify_generic(
            kg_args[0][lo:hi], kg_args[1][lo:hi], kg_args[2][lo:hi], keys,
            kg_args[4][lo:hi]), COLD_CHUNK, 5),
        "plain_ms": cuda_ms(lambda: ed25519.verify_forward_raw(*kg_args), 1),
        "bound": bound_ms(COLD_CHUNK * kg_imads(),
                          COLD_CHUNK * (96 + 4 + 1) + keys.numel()),
        "max_abs_err": int((got.int() - want.int()).abs().max())}

    # K-B on 32 keys and on the base point alone, byte for byte against the
    # plain build (both sides canonical 32-byte encodings)
    s, h, r, slots, hot_keys = device_rows(*hot, dev)
    xy = hot_keys[:tables.BUILD_K, :2].contiguous()
    kb_keys = xy.shape[0]
    kb_slots = torch.arange(kb_keys, dtype=torch.int32, device=dev)
    kb_table = tables.new_table(kb_keys, dev)
    tables.build_tables_into(kb_table, kb_slots, xy)

    def plain_build(key_xy):
        return field.to_bytes(tables.build_tables(
            field.from_bytes(key_xy[:, 0]), field.from_bytes(key_xy[:, 1])))

    diff = (kb_table.int() - plain_build(xy).int()).abs()
    kb_bad = int((diff > 0).sum())
    b_xy = torch.from_numpy(tables.base_xy()).to(dev)
    b_slot = torch.zeros(1, dtype=torch.int32, device=dev)
    b_table = tables.build_tables_into(tables.new_table(1, dev), b_slot, b_xy)
    kb_base_bad = int((b_table != plain_build(b_xy)).sum())
    base = tables.base_point_table(dev)
    kb_base_bad += int((base != b_table[0]).sum())
    timing["K-B"] = {
        "ms": cuda_ms(lambda: tables.build_tables_into(kb_table, kb_slots, xy), 5),
        "ms_1": cuda_ms(lambda: tables.build_tables_into(b_table, b_slot, b_xy), 5),
        "plain_ms": cuda_ms(lambda: plain_build(xy), 1),
        "bound": bound_ms(kb_keys * kb_imads(),
                          kb_table.numel() + xy.numel() + 4 * kb_keys),
        "max_abs_err": int(diff.max())}
    del diff

    # K-B's chain floor: one warp's chain of q_dbl (the check kernel
    # dbl_chain, held against the plain chain), timed at 252 and 4 x 252
    # doublings; the difference is 756 doublings' latency in a row
    one_key = xy[:1]
    chain_bad = sum(int((tables.dbl_chain(one_key, k) != tables.dbl_chain_plain(
        one_key, k)).sum()) for k in (CHAIN_DBLS, 4 * CHAIN_DBLS))
    chain_ms = cuda_ms(lambda: tables.dbl_chain(one_key, CHAIN_DBLS), 20)
    chain4_ms = cuda_ms(lambda: tables.dbl_chain(one_key, 4 * CHAIN_DBLS), 20)
    dbl_ms = (chain4_ms - chain_ms) / (3 * CHAIN_DBLS)
    timing["K-B"]["chain_floor_ms"] = CHAIN_DBLS * dbl_ms

    # K-T at the hot path's chunk shape, on a table built by K-B; the plain
    # version reads the same bytes
    key_table = tables.new_table(HOT_KEYS, dev)
    tables.build_tables_into(
        key_table, torch.arange(HOT_KEYS, dtype=torch.int32, device=dev),
        hot_keys[:, :2].contiguous())
    kt_args = (s[:HOT_CHUNK], h[:HOT_CHUNK], slots[:HOT_CHUNK], r[:HOT_CHUNK],
               key_table, base)
    got = tables.verify_tables(*kt_args)
    want = tables.verify_tables_forward(*kt_args)
    kt_bad = int((got != want).sum())
    # a ragged n (the last warp's pairs past n store nothing) and the
    # admission chunk, against the plain version on the same rows
    kt_sub = {}
    for m in (HOT_CHUNK - 1, ADMISSION_CHUNK):
        kt_sub[m] = tuple(a[:m] for a in kt_args[:4]) + (key_table, base)
        kt_bad += int((tables.verify_tables(*kt_sub[m])
                       != tables.verify_tables_forward(*kt_sub[m])).sum())
    # slots outside the table: those signatures rejected, no other moved
    out_rows = [5, 9]
    bad_slots = slots[:HOT_CHUNK].clone()
    bad_slots[out_rows] = torch.tensor([HOT_KEYS, -1], dtype=torch.int32,
                                       device=dev)
    got_out = tables.verify_tables(kt_args[0], kt_args[1], bad_slots,
                                   *kt_args[3:])
    keep = torch.ones(HOT_CHUNK, dtype=torch.bool, device=dev)
    keep[out_rows] = False
    slot_rejects = bool(want[out_rows].all()) and not bool(got_out[out_rows].any())
    kt_bad += int((got_out[keep] != want[keep]).sum())
    timing["K-T"] = {
        "ms": cuda_ms(lambda: tables.verify_tables(*kt_args), 5),
        "ms_2048": cuda_ms(
            lambda: tables.verify_tables(*kt_sub[ADMISSION_CHUNK]), 10),
        "ms_2_streams": two_stream_ms(dev, lambda lo, hi: tables.verify_tables(
            *(a[lo:hi] for a in kt_args[:4]), key_table, base), HOT_CHUNK, 5),
        "plain_ms": cuda_ms(lambda: tables.verify_tables_forward(*kt_args), 1),
        "bound": bound_ms(HOT_CHUNK * kt_imads(),
                          HOT_CHUNK * (96 + 4 + 1) + key_table.numel()
                          + base.numel()),
        "bound_2048": bound_ms(ADMISSION_CHUNK * kt_imads(),
                               ADMISSION_CHUNK * (96 + 4 + 1)
                               + key_table.numel() + base.numel()),
        "max_abs_err": int((got.int() - want.int()).abs().max())}
    emit({"phase": "kernels-vs-plain",
          "K-G": {"signatures": [COLD_CHUNK, RAGGED_N, ADMISSION_CHUNK],
                  "mismatches": kg_bad, "imads_per_sig": kg_imads(),
                  "ms": timing["K-G"]["ms"],
                  "ms_2048": timing["K-G"]["ms_2048"],
                  "bound_ms": timing["K-G"]["bound"][0],
                  "bound_ms_2048": timing["K-G"]["bound_2048"][0]},
          "K-B": {"keys": kb_keys, "mismatched_bytes": kb_bad,
                  "base_table_mismatched_bytes": kb_base_bad,
                  "imads_per_key": kb_imads(), "ms": timing["K-B"]["ms"],
                  "ms_1": timing["K-B"]["ms_1"],
                  "bound_ms": timing["K-B"]["bound"][0],
                  "chain_check_mismatched_bytes": chain_bad,
                  "chain_ms_252": chain_ms, "chain_ms_1008": chain4_ms,
                  "dbl_latency_us": 1e3 * dbl_ms,
                  "chain_floor_ms": timing["K-B"]["chain_floor_ms"]},
          "K-T": {"signatures": [HOT_CHUNK, HOT_CHUNK - 1, ADMISSION_CHUNK],
                  "mismatches": kt_bad, "slot_outside_rejects": slot_rejects,
                  "imads_per_sig": kt_imads(), "ms": timing["K-T"]["ms"],
                  "ms_2048": timing["K-T"]["ms_2048"],
                  "bound_ms": timing["K-T"]["bound"][0],
                  "bound_ms_2048": timing["K-T"]["bound_2048"][0]}})
    if kg_bad or kb_bad or kb_base_bad or chain_bad or kt_bad \
            or not slot_rejects:
        raise AssertionError("a kernel disagrees with its plain version")

    timing["K-W"] = graft_entry_phase(kw_args)

    # -- adversarial vectors, on the generic path and on the table path ---
    oracle = "libsodium" if sodium.available() else "fixed verdicts"
    emit({"phase": "adversarial", "oracle": oracle,
          "cases": check_adversarial(dev, 1 << 62)})
    table_path = {"K-B": tables.build_tables_into, "K-T": tables.verify_tables,
                  "K-G": ed25519.verify_generic}
    before = {k: fn.launches for k, fn in table_path.items()}
    cases = check_adversarial(dev, 1)
    launched = {k: fn.launches - before[k] for k, fn in table_path.items()}
    emit({"phase": "adversarial-table-path", "oracle": oracle,
          "hot_threshold": 1, "cases": cases, "launches": launched})
    if launched["K-B"] < 1 or launched["K-T"] < 1 or launched["K-G"]:
        raise AssertionError(f"the table-path vectors did not run on K-B and "
                             f"K-T alone: {launched}")

    # -- main path, hot keys (bench config #2) -----------------------------
    # through the module-level entry that catchup and admission call, with
    # no device argument (the default device, the cached verifier)
    expect = N_SIGS - sum(1 for i in range(N_SIGS) if i % 100 == 99)  # 64,881
    ed25519._verifiers.clear()
    first = drive(lambda: ed25519.verify_batch(*hot, chunk_size=HOT_CHUNK))
    steady = drive(lambda: ed25519.verify_batch(*hot, chunk_size=HOT_CHUNK))
    stats = ed25519._verifier_for(HOT_CHUNK, 256, 4, None).stats
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
    stats = ed25519._verifier_for(COLD_CHUNK, 256, 1 << 62, None).stats
    emit({"phase": "main-cold", "accepted": int(first["verdicts"].sum()),
          "stats": stats, "first_call": report(first),
          "steady": report(steady)})
    if int(first["verdicts"].sum()) != expect \
            or int(steady["verdicts"].sum()) != expect:
        raise AssertionError(f"cold path accepted {int(first['verdicts'].sum())}, "
                             f"{int(steady['verdicts'].sum())}, not {expect}")
    cold_launches = first["launches"]
    if stats["generic_sigs"] != 2 * N_SIGS or cold_launches != {
            "K-B": 0, "K-T": 0, "K-G": N_SIGS // COLD_CHUNK, "K-QF": 0,
            "K-QC": 0, "K-W": 0}:
        raise AssertionError(f"cold path did not run on K-G: {stats} "
                             f"{cold_launches}")
    cold_runs = first, steady

    emit({"phase": "end-to-end", "signer": signer_name(),
          "hot_sigs_per_s": N_SIGS / hot_runs[0]["seconds"],
          "hot_steady_sigs_per_s": N_SIGS / hot_runs[1]["seconds"],
          "cold_sigs_per_s": N_SIGS / cold_runs[0]["seconds"],
          "cold_steady_sigs_per_s": N_SIGS / cold_runs[1]["seconds"]})

    # -- the signature seam: decode, hash, verify, seed, SignatureChecker --
    seam = signature_seam()
    seam["nvidia_smi"] = smi
    emit(seam)

    # -- quorum intersection (bench.py config 5) ----------------------------
    widest, at_65536 = quorum_kernels_vs_plain(dev)
    timing.update(widest)
    quorum_launches = quorum_main_paths()

    # -- the multi-card forms (verify, prune, the accept-count sum) --------
    multi_gpu_phase(dev, hot, cold, timing, at_65536["K-QF"])

    # -- the kernels line -------------------------------------------------
    meta = {
        "K-G": ("stellar_core_tpu_torch/csrc/verify_generic.cu",
                "stellar_core_tpu/accel/ed25519.py:173",
                cold_launches["K-G"]),
        "K-B": ("stellar_core_tpu_torch/csrc/tables.cu",
                "stellar_core_tpu/accel/tables.py:51", hot_launches["K-B"]),
        "K-T": ("stellar_core_tpu_torch/csrc/tables.cu",
                "stellar_core_tpu/accel/tables.py:109", hot_launches["K-T"]),
        "K-QF": ("stellar_core_tpu_torch/csrc/quorum.cu",
                 "stellar_core_tpu/accel/quorum.py:163",
                 quorum_launches["K-QF"]),
        "K-QC": ("stellar_core_tpu_torch/csrc/quorum.cu",
                 "stellar_core_tpu/accel/quorum.py:195",
                 quorum_launches["K-QC"]),
        "K-W": ("stellar_core_tpu_torch/csrc/verify_generic.cu",
                "stellar_core_tpu/accel/ed25519.py:142",
                timing["K-W"]["launches"]),
    }
    kernels = []
    for name, (source, replaces, count) in meta.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": count,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t.get("library_ms")})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
