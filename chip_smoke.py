#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from stellar_core_tpu_torch/csrc (nvcc, at
first use; K-G, K-W, K-T and K-B must show no spills, K-G and K-W no stack
that could hold their 16-entry tables, K-T and K-B none that could hold a
point), holds each one against its plain PyTorch version on the card (K-G
also at a ragged 8,191 signatures, at the admission chunk of 2,048 and at
admission's batch of 256, K-T at a ragged 16,383, at 2,048 and with a slot outside the table, K-B at 32
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

* ledger apply, catchup replay's apply half (ledger-apply): bench.py's
  replay archive at the replay bench's size (120 accounts, every 4th
  co-signed, 40 payments a ledger, 1,100 payment ledgers, 1,150 ledgers
  to a checkpoint boundary; 55,020 signatures, every 100th payment
  signature corrupted) closed once on the host as the oracle, then
  replayed from genesis a checkpoint of 64 ledgers at a time: envelopes
  decoded, signatures paired as catchup's PreverifyPipeline pairs them,
  ``verify_batch_async`` (K-G, then K-B + K-T), the verdicts seeded, each
  ledger closed by ``LedgerManager.close_ledger`` against the oracle's
  hash; then once more through the native apply engine (native/capply.c)
  where libsodium loads.  Every ledger's hash and result set must be the
  oracle's, with no verdict recomputed;

* catchup (catchup): the same chain, published by the port's
  HistoryManager into a FileHistoryArchive as the oracle closes it (18
  checkpoints; its tip must be the oracle's last ledger), replayed by
  the port's CatchupManager(accel=True) through the CatchupWork DAG and
  PreverifyPipeline's device worker thread: a warm pass to ledger 127,
  then (a) the defaults (chunk 2,048, K-G, the poll profile), (b) the
  bench's settings (chunk 8,192, hot_threshold 4: K-B + K-T), (c) as (b)
  with the race profile, and (d) ``python -m stellar_core_tpu_torch
  catchup --parallel 3 --accel cuda``, three range workers on the one
  card.  Every run must end on the archive's tip hash, (a) must launch
  K-G and (b) and (c) K-B and K-T; each run prints its ledgers/s, hit
  rate, offload counters, CPU fallback verifies and their seconds, and
  launches and CUDA-event time a kernel (events recorded by the worker
  thread: where the card waits on the host they also hold the host's
  delay, so they are upper bounds);

* admission (admission): the live node's batched intake,
  ``AdmissionCampaign`` with accel on the card (the race profile; a warm
  batch at construction, waited for before the runs; then K-G at about
  256 signatures a launch).  (a) bench.py's on-device admission row (4,000
  accounts, batch 256, a tx set of 500 operations, backlog 2,000, 3
  ledgers of 500 offered transactions) against the same campaign and seed
  with accel off: every status count and every closed ledger's hash must
  be the oracle's.  (b) bench.py's sustained and 2x overload campaign
  (100,000 seed-derived accounts over BucketListDB in a temporary
  directory, cap 500: 4 ledgers of 500 offered, then 6 of 1,000), held to
  the bench's bounds (peak queue depth at most 4 x 500, peak admission
  depth at most the backlog of 2,000);

* consensus (consensus): a standalone validator, ``Herder`` on a
  VIRTUAL_TIME clock with a singleton quorum set and admission on the
  card (batch 256, backlog 2,000), a tx set of 1,000 operations, 10,000
  accounts installed by ``LoadGenerator.install_account_pool``: 10
  ledgers, each after a burst of 1,000 payments through
  ``recv_transaction``, closed by SCP (nominate, ballot, externalize,
  ``close_ledger``), against the same script with accel off: every
  ledger's hash, tx-set hash and result set must be the oracle's, and
  every admitted transaction applied.  In admission and consensus the
  pipeline must warm, every batch of at least accel_min_sigs signatures
  after it warmed must go to K-G, signatures must be offloaded, and no
  collect may lose its race or fall back to the CPU; a device job that
  raises fails the run.  Each prints its rates (tx/s, also net of the
  clients' key derivations and signing, which run in the campaign's
  loop), admission latency and batch sizes, the CPU verifies (sync path,
  small batches) apart from the offloaded signatures, K-G's launches and
  the collect wait;

* node (node): a node served by the port's ``run`` entry point
  (``python -m stellar_core_tpu_torch run --conf node.toml``, called on
  the main thread; the clients drive its HTTP admin from a helper thread
  and stop it with SIGTERM, the handler ``run`` installs): a TOML config
  with ACCEL = "cuda", admission on (batch 256, backlog 2,000),
  ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING (a ledger a second, a
  checkpoint every 8), a DATABASE and bucket directory (kept for the
  commands phase), a local HISTORY archive and an HTTP_PORT.  Over
  ``/upgrades`` the tx set grows to 1,000 operations, over ``/tx`` 101
  transactions create 10,000 accounts, then a burst of 2,000 signed
  payments goes to ``/tx`` from 8 client threads: every answer must be
  accepted (PENDING) or a reasoned rejection, every accepted transaction
  applied, at least two checkpoints published, and the archive the node
  published, replayed by the port's CatchupManager with accel off, must
  end on the node's hash of that ledger (its tx sets follow the wall
  clock, so there is no accel-off run to compare hash by hash);

* network (network): three validators of ``simulation.Simulation`` on a
  VIRTUAL_TIME clock, a 2-of-3 quorum set (SDF's testnet layout: three
  validators), loopback peers authenticated by ``PeerAuth`` (X25519 by
  libsodium, or where it is missing by crypto/rfc7748.py), each node's
  admission on the card (batch 256, backlog 2,000), 10,000 accounts: a
  burst of 1,000 payments submitted at one node and flooded by the
  overlay, then 10 ledgers closed by SCP; every node must close every
  ledger on the same hash, and the same script with accel off must give
  the same ledger, tx-set and result set hashes.  In node and network
  the pipelines are held to the admission phase's card-use limits; each
  prints its rates, the X25519 path, K-G's launches, the collect wait and
  its seconds;

* fleet (fleet): ``python -m stellar_core_tpu_torch fleet --nodes 5`` as a
  subprocess on the command's defaults, the reference's acceptance fleet:
  five `run` processes over real TCP (a simple majority, a checkpoint
  every 8 ledgers, one shared archive), traffic at 25 tx/s over 60
  accounts, node 2 killed at ledger 6 and rejoined by ``catchup --parallel
  2`` against the live archive, a 3-2 partition for 6 s and its heal, a
  rolling config change over all five; no STPU_ACCEL, so every node and
  range worker takes ACCEL "cuda".  The command must exit 0 and its
  report meet the acceptance test's SLOs and checks
  (tests/test_fleet.py:218-269); every node process must have opened the
  card and launched K-G (its warm batch; its /metrics ``accel`` section,
  kept per process in the report), every range of the rejoin must have
  launched K-G and shipped verdicts from the card (its line in
  catchup.log), and the archive replayed on the CPU (``catchup --accel
  none``) must end on the hash the nodes reported for its tip.  It prints
  the seconds, ledgers/s, PENDING and shed counts, the retracking and roll
  seconds, K-G launches and admission batches on the card and on the CPU
  per node, the rejoin's ranges, and each process's card memory where
  ``nvidia-smi --query-compute-apps`` answers;

* commands (commands): the port's command line over the node phase's
  durable state after it stopped (its DATABASE, buckets and archive),
  ACCEL = "cuda": self-check, offline-info, diag-bucket-stats,
  dump-ledger, verify-checkpoints and report-last-history-checkpoint
  (held to the node's last ledger and its archive's CPU replay), publish,
  and new-hist into a second archive;

* determinism (determinism): (a) the port's corelint
  (``python -m stellar_core_tpu_torch.lint``) over the port, this script
  and native/*.c, held to its baseline
  (stellar_core_tpu_torch/lint/LINT_BASELINE.json), the four determinism
  rules alone, and ``python -m stellar_core_tpu_torch._native_build
  --warn-check``, whose only allowed failure is native/capply.c's
  -Warray-parameter mismatches (a fault of the shared source that GCC 11
  and later report, see WARN_KNOWN); (b) the hash-seed differential at
  the reference's defaults (``simulation.hashseed_diff``: the 51-node
  partition-flap-heal chaos campaign and the Soroban campaign of 50
  ledgers, each in two processes under PYTHONHASHSEED 0 and 424242 with
  the detguard armed), both IDENTICAL with regions entered and no trip;
  (c) the network phase's card run (network_run) in two processes, one
  under PYTHONHASHSEED 0 and one under 424242, both with STPU_DETGUARD=1:
  every ledger of each on the accel-off run's hashes, K-G launched in
  each, the guard armed with regions entered and no trip.  (b) runs
  beside (c);

* the graft entry (stellar_core_tpu_torch/graft_entry.py): K-W, the
  windows form of K-G, against its plain version on the cold path's 8,192
  signatures, its fused accept count, and ``entry()``'s step; then the
  multi-card forms, as shards on the one card the machine has:
  ``dryrun_multigpu(4)`` (its third check a small archive replayed by
  CatchupManager with the offload over the 4 shards), both verify paths
  with ``devices=[card, card]``
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

import faulthandler
import hashlib
import json
import os
import random
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from stellar_core_tpu_torch import _cuda_build, graft_entry
from stellar_core_tpu_torch import testutils as qmaps
from stellar_core_tpu_torch import xdr as X
from stellar_core_tpu_torch.accel import curve, ed25519, field, quorum, tables
from stellar_core_tpu_torch.catchup.catchup import CatchupManager
from stellar_core_tpu_torch.crypto import keys as crypto_keys
from stellar_core_tpu_torch.crypto import sodium
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.crypto.sha import sha256
from stellar_core_tpu_torch.device import Shards, parts
from stellar_core_tpu_torch.history.archive import (CATEGORY_LEDGER,
                                                    FileHistoryArchive,
                                                    category_path)
from stellar_core_tpu_torch.history.manager import HistoryManager
from stellar_core_tpu_torch.herder.quorum_intersection import (
    QuorumIntersectionChecker)
from stellar_core_tpu_torch.herder.tx_queue import AddResult
from stellar_core_tpu_torch.ledger import native_apply
from stellar_core_tpu_torch.ledger.manager import LedgerManager
from stellar_core_tpu_torch.simulation import hashseed_diff
from stellar_core_tpu_torch.testutils import (TestAccount, build_tx,
                                              create_account_op,
                                              native_payment_op)
from stellar_core_tpu_torch.transactions.frame import TransactionFrame
from stellar_core_tpu_torch.transactions.signature_checker import (
    SignatureChecker)
from stellar_core_tpu_torch.util import metrics
from stellar_core_tpu_torch.util.metrics import registry
from stellar_core_tpu_torch.xdr import codec as xdr_codec

P = field.P
L = ed25519.L
N_SIGS = 65536
HOT_KEYS, HOT_CHUNK = 64, 16384
COLD_KEYS, COLD_CHUNK = 4096, 8192
# the admission pipeline's chunk (stellar_core_tpu/herder/admission.py:95)
# and its batch (:89-92: a flush at 256 signatures, one K-G launch), and a
# ragged chunk whose last warp of quads is partial
ADMISSION_CHUNK, ADMISSION_BATCH, RAGGED_N = 2048, 256, COLD_CHUNK - 1
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
        if on_card:
            check_path_kernels(f"seam {name}", path["verify"]["launches"],
                               path["counters"])
        report[name] = path
    return report


def check_path_kernels(what: str, launches: dict, counters: dict) -> None:
    """A verify path ran on its kernels alone: the K-G path (`what` ends
    in K-G) on K-G, the K-B + K-T path on K-B and K-T, and on K-G only
    where some signatures' keys stayed cold."""
    n = launches
    if what.endswith("K-G"):
        ran = n["K-G"] >= 1 and n["K-B"] == n["K-T"] == 0
    else:
        ran = n["K-B"] >= 1 and n["K-T"] >= 1 and (n["K-G"] >= 1) \
            == (counters["accel.ed25519.generic-sigs"] > 0)
    if not ran:
        raise AssertionError(f"{what}: launches {n}")


# -- ledger apply: catchup replay's apply half on the card's verdicts --------

# bench.py's replay archive (build_archive, :166-244) at the replay bench's
# size (:2539-2542): 120 accounts created 50 to a transaction, every 4th
# given an extra ed25519 signer by setOptions that co-signs its payments,
# 40 native payments a ledger drawn with random.Random(11), 1,100 payment
# ledgers, then empty ledgers up to a checkpoint boundary; every 100th
# payment signature corrupted
APPLY_ACCOUNTS, APPLY_MULTISIG_EVERY, APPLY_TXS_PER_LEDGER = 120, 4, 40
APPLY_PAYMENT_LEDGERS = 1100
APPLY_GROUP = 64                    # a checkpoint's ledgers
APPLY_PASSPHRASE = "chip smoke apply net"
APPLY_PATHS = (("K-G", 1 << 62), ("K-B+K-T", 4))
APPLY_ORACLE_CHECK_EVERY = 50


def apply_archive(n_payment_ledgers: int = APPLY_PAYMENT_LEDGERS,
                  n_accounts: int = APPLY_ACCOUNTS,
                  txs_per_ledger: int = APPLY_TXS_PER_LEDGER,
                  group: int = APPLY_GROUP,
                  archive_dir: str = None) -> dict:
    """The oracle run: bench.py's build_archive chain closed on the host
    by LedgerManager(nid, invariant_manager=None), each ledger's
    signatures seeded into the verify cache before its close with the
    verdicts fixed by construction (False where corrupted).  Returns, a
    ledger each, its sequence number, close time, envelopes (XDR bytes),
    hash and the hash of its TransactionResultSet; the result codes
    counted; each (pk, sig, hash) pair's fixed verdict; the set-up's
    seconds.  1 in APPLY_ORACLE_CHECK_EVERY fixed verdicts, and the first
    rejections, are checked with sodium.verify_detached (libsodium, or its
    RFC 8032 fallback).  The chain ends on a ledger that closes a group of
    `group` ledgers (a checkpoint boundary at 64).  With `archive_dir`,
    the port's HistoryManager publishes every checkpoint of the chain into
    a FileHistoryArchive there as the oracle closes it (bench.py's
    build_archive), for the catchup phase."""
    t_start = time.perf_counter()
    nid = sha256(APPLY_PASSPHRASE.encode())
    mgr = LedgerManager(nid, invariant_manager=None)
    mgr.start_new_ledger()
    history = None if archive_dir is None else HistoryManager(
        mgr, APPLY_PASSPHRASE, [FileHistoryArchive(archive_dir)])
    genesis = mgr.lcl_hash
    rsk = mgr.root_account_secret()
    top = TestAccount(mgr, rsk, mgr.root.get_entry(X.account_key_xdr(
        rsk.public_key.ed25519)).data.value.seqNum)
    sks = [SecretKey(bytes([1 + (i % 250)]) * 31 + bytes([i // 250]))
           for i in range(n_accounts)]
    extras = {i: SecretKey(bytes([200 + (i % 50)]) * 31 + bytes([i // 50]))
              for i in range(0, n_accounts, APPLY_MULTISIG_EVERY)}
    # the account created in ledger 2 + k starts at seqNum (2 + k) << 32
    accts = [TestAccount(mgr, sk, (2 + i // 50) << 32)
             for i, sk in enumerate(sks)]
    n_sigs = [0]

    def pairs_of(frame, signers, corrupt: bool):
        """The frame's (pk, sig, hash, fixed verdict) a signature, every
        100th payment signature corrupted first."""
        out = []
        for sk, d in zip(signers, frame.envelope.value.signatures):
            bad = corrupt and n_sigs[0] % 100 == 99
            if bad:
                d.signature = bytes([d.signature[0] ^ 1]) + d.signature[1:]
            n_sigs[0] += corrupt
            out.append((sk.public_key.ed25519, d.signature,
                        frame.content_hash(), not bad))
        return out

    # the set-up ledgers: creations, then the co-signers' setOptions
    plan = []
    for start in range(0, n_accounts, 50):
        f = top.tx([create_account_op(X.AccountID.ed25519(
            sk.public_key.ed25519), 10 ** 12) for sk in sks[start:start + 50]])
        plan.append(([f], pairs_of(f, [rsk], False)))
    setopts = [(accts[i].tx([X.Operation(body=X.OperationBody.setOptionsOp(
        X.SetOptionsOp(signer=X.Signer(
            key=X.SignerKey.ed25519(ex.public_key.ed25519), weight=1))))]),
        sks[i]) for i, ex in extras.items()]
    for start in range(0, len(setopts), 40):
        chunk = setopts[start:start + 40]
        plan.append(([f for f, _ in chunk], [p for f, sk in chunk
                                             for p in pairs_of(f, [sk], False)]))
    t_sign = time.perf_counter()
    rng = random.Random(11)
    for _ in range(n_payment_ledgers):
        frames, pairs = [], []
        for _ in range(txs_per_ledger):
            i = rng.randrange(n_accounts)
            a = accts[i]
            op = native_payment_op(accts[rng.randrange(n_accounts)].account_id,
                                   1000 + rng.randrange(10 ** 6))
            signers = [a.secret] + ([extras[i]] if i in extras else [])
            f = build_tx(nid, a.secret, a.next_seq(), [op], signers=signers)
            frames.append(f)
            pairs += pairs_of(f, signers, True)
        plan.append((frames, pairs))
    sign_s = time.perf_counter() - t_sign
    t_close = time.perf_counter()
    ledgers, fixed, codes = [], {}, {}
    corrupted_txs = {h for _, pairs in plan for _, _, h, ok in pairs
                     if not ok}
    close_time, at = 1_600_000_000, 0
    while at < len(plan) or (mgr.lcl_header.ledgerSeq + 1) % group:
        frames, pairs = plan[at] if at < len(plan) else ([], [])
        at += 1
        crypto_keys.seed_verify_cache(pairs)
        close_time += 5
        arts = mgr.close_ledger(frames, close_time)
        if history is not None:
            history.ledger_closed(arts)
        results = arts.result_entry.txResultSet
        for pair in results.results:
            name = pair.result.result.switch.name
            codes[name] = codes.get(name, 0) + 1
            if pair.transactionHash in corrupted_txs and name == "txSUCCESS":
                raise AssertionError("a transaction with a corrupted "
                                     "signature succeeded")
        ledgers.append({"seq": mgr.lcl_header.ledgerSeq,
                        "close_time": close_time,
                        "envelopes": [f.envelope.to_xdr() for f in frames],
                        "hash": mgr.lcl_hash,
                        "results_hash": sha256(results.to_xdr())})
        fixed.update(((pk, sig, h), ok) for pk, sig, h, ok in pairs)
    close_s = time.perf_counter() - t_close
    crypto_keys.clear_verify_cache()
    t_check = time.perf_counter()
    items = list(fixed.items())
    checked = items[::APPLY_ORACLE_CHECK_EVERY] \
        + [kv for kv in items if not kv[1]][:8]
    wrong = sum(1 for (pk, sig, h), ok in checked
                if sodium.verify_detached(sig, h, pk) != ok)
    if wrong:
        raise AssertionError(f"{wrong} fixed verdicts are not the verifier's")
    return {"nid": nid, "genesis": genesis, "ledgers": ledgers,
            "codes": codes, "fixed": fixed,
            "corrupted": sum(1 for ok in fixed.values() if not ok),
            "checked_verdicts": len(checked), "sign_s": sign_s,
            "published": [] if history is None
            else list(history.published_checkpoints),
            "oracle_close_s": close_s,
            "check_s": time.perf_counter() - t_check,
            "build_s": time.perf_counter() - t_start}


def apply_pairs(frames, root, harvested: dict):
    """PreverifyPipeline.dispatch's pairing (stellar_core_tpu/catchup/
    catchup.py:360-438), this phase's own copy: each signature's hint
    against the ed25519 signers of the transaction's source accounts, read
    from `root` (the state before the group), plus every ed25519 signer
    the SET_OPTIONS operations name, harvested into `harvested` (hint ->
    keys) before pairing and kept across groups.  Returns (pks, sigs,
    msgs, signatures seen)."""
    cache = {}

    def signers_of(aid: bytes):
        if aid not in cache:
            entry = root.get_entry(X.account_key_xdr(aid))
            cache[aid] = [] if entry is None else [
                sg.key.value for sg in entry.data.value.signers
                if sg.key.switch == X.SignerKeyType.SIGNER_KEY_TYPE_ED25519]
        return cache[aid]

    for frame in frames:
        for op in frame.operations:
            if op.body.switch == X.OperationType.SET_OPTIONS:
                signer = op.body.value.signer
                if signer is not None and signer.key.switch == \
                        X.SignerKeyType.SIGNER_KEY_TYPE_ED25519:
                    keys = harvested.setdefault(signer.key.value[28:32], [])
                    if signer.key.value not in keys:
                        keys.append(signer.key.value)
    pks, sigs, msgs, total = [], [], [], 0
    for frame in frames:
        h = frame.content_hash()
        ids = [frame.source_account_id().value]
        if hasattr(frame, "inner"):
            ids.append(frame.inner.source_account_id().value)
        ids += [X.muxed_to_account_id(op.sourceAccount).value
                for op in frame.operations if op.sourceAccount is not None]
        candidates = list(ids)
        for aid in ids:
            candidates += signers_of(aid)
        total += len(frame.signatures)
        for d in frame.signatures:
            seen = set()
            for pk in candidates + harvested.get(d.hint, []):
                if d.hint == pk[28:32] and pk not in seen:
                    seen.add(pk)
                    pks.append(pk)
                    sigs.append(d.signature)
                    msgs.append(h)
    return pks, sigs, msgs, total


class _CountedChecks:
    """Counts the ed25519 checks a close makes: crypto.keys.verify_sig
    wrapped while the context is open."""

    def __init__(self):
        self.calls = 0

    def __enter__(self):
        self._orig = crypto_keys.verify_sig

        def verify_sig(*args):
            self.calls += 1
            return self._orig(*args)

        crypto_keys.verify_sig = verify_sig
        return self

    def __exit__(self, *exc):
        crypto_keys.verify_sig = self._orig


def apply_replay(archive: dict, hot: int, native: bool = False,
                 device=None, group: int = APPLY_GROUP) -> dict:
    """One replay of the oracle's chain from genesis on a fresh
    LedgerManager, the verify cache cleared, each group of `group`
    ledgers (a checkpoint) in four steps: decode its envelopes and pair
    its signatures (apply_pairs; on the native run the engine's
    extract_pairs), verify_batch_async as catchup.py:512-530 calls it
    (chunk 2,048, `hot` as hot_threshold), seed the verdicts (the process
    verify cache; on the native run the engine's), close each ledger
    (close_ledger with the oracle's hash as expected_ledger_hash, which
    raises on a mismatch; on the native run through the engine, its hash
    compared after each close).  Raises unless every ledger's hash and
    result set equal the oracle's, every verdict is the oracle's, the
    result codes count as the oracle's, and (Python runs) no verdict was
    recomputed, every ed25519 check hit the cache and the verifier counted
    every pair.  Launches are counted from 0 and each launch's CUDA-event
    time summed over the run."""
    nid = archive["nid"]
    mgr = LedgerManager(nid, invariant_manager=None)
    mgr.start_new_ledger()
    if mgr.lcl_hash != archive["genesis"]:
        raise AssertionError("replay genesis differs from the oracle's")
    if native and not mgr.attach_native_close():
        raise AssertionError("native close did not attach")
    bridge = mgr.native_closer.bridge if native else None
    ed25519._verifiers.clear()      # a fresh verifier, as a new replay has
    crypto_keys.clear_verify_cache()
    reg = registry()
    before = {c: reg.counter(c).value for c in SEAM_COUNTERS}
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    _cuda_build.launch_events = []
    steps = dict.fromkeys(("pair", "verify", "seed", "close"), 0.0)
    codes, harvested = {}, {}
    n_pairs = n_sigs = bad_verdicts = 0
    ledgers = archive["ledgers"]
    groups = {}
    for i, led in enumerate(ledgers):
        groups.setdefault(led["seq"] // group, []).append(i)
    t_run = time.perf_counter()
    try:
        with _CountedChecks() as checks:
            for idx in groups.values():
                t0 = time.perf_counter()
                frames = [[TransactionFrame.make_from_wire(
                    nid, X.TransactionEnvelope.from_xdr(raw))
                    for raw in ledgers[i]["envelopes"]] for i in idx]
                if native:
                    recs = [X.TransactionHistoryEntry(
                        ledgerSeq=ledgers[i]["seq"], txSet=X.TransactionSet(
                            previousLedgerHash=(ledgers[i - 1]["hash"] if i
                                                else archive["genesis"]),
                            txs=[f.envelope for f in fl])).to_xdr()
                        for i, fl in zip(idx, frames)]
                    pks, sigs, msgs, total = bridge.extract_pairs(recs)
                else:
                    pks, sigs, msgs, total = apply_pairs(
                        [f for fl in frames for f in fl], mgr.root, harvested)
                t1 = time.perf_counter()
                verdicts = ed25519.verify_batch_async(
                    pks, sigs, msgs, chunk_size=SEAM_CHUNK,
                    tail_floor=SEAM_CHUNK, hot_threshold=hot,
                    device=device)() if pks else np.zeros(0, dtype=bool)
                t2 = time.perf_counter()
                if native:
                    bridge.seed_verdicts(pks, sigs, msgs, verdicts)
                else:
                    crypto_keys.seed_verify_cache(
                        (pks[k], sigs[k], msgs[k], bool(verdicts[k]))
                        for k in range(len(pks)))
                t3 = time.perf_counter()
                for i, fl in zip(idx, frames):
                    led = ledgers[i]
                    arts = mgr.close_ledger(
                        fl, led["close_time"],
                        expected_ledger_hash=None if native else led["hash"])
                    results = arts.result_entry.txResultSet
                    if mgr.lcl_hash != led["hash"] or \
                            sha256(results.to_xdr()) != led["results_hash"]:
                        raise AssertionError(
                            f"ledger {led['seq']} differs from the oracle's")
                    for pair in results.results:
                        name = pair.result.result.switch.name
                        codes[name] = codes.get(name, 0) + 1
                t4 = time.perf_counter()
                fixed = archive["fixed"]
                bad_verdicts += sum(
                    1 for k in range(len(pks))
                    if bool(verdicts[k]) != fixed.get(
                        (pks[k], sigs[k], msgs[k]), False))
                n_pairs += len(pks)
                n_sigs += total
                for k, dt in zip(steps, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                    steps[k] += dt
        run_s = time.perf_counter() - t_run
        events = _cuda_build.launch_events
    finally:
        _cuda_build.launch_events = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    kernel_ms = sum(start.elapsed_time(end) for _, start, end in events)
    delta = {c: reg.counter(c).value - before[c] for c in SEAM_COUNTERS}
    n = len(ledgers)
    report = {
        "hot_threshold": hot, "engine": "native" if native else "python",
        "ledgers": n, "signatures": n_sigs, "pairs": n_pairs,
        "verdict_mismatches": bad_verdicts, "codes": codes,
        "seconds": run_s, "ledgers_per_s": n / run_s,
        "steps_s": steps,
        "steps_ledgers_per_s": {k: n / v if v else None
                                for k, v in steps.items()},
        "counters": delta, "ed25519_checks": checks.calls,
        "launches": {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()},
        "kernel_ms": kernel_ms, "kernel_share": kernel_ms / 1e3 / run_s,
        "final_hash": mgr.lcl_hash.hex()}
    counted = delta["accel.ed25519.table-sigs"] \
        + delta["accel.ed25519.generic-sigs"] \
        + delta["accel.ed25519.rejected-prep"]
    fails = []
    if bad_verdicts:
        fails.append("verdicts differ from the oracle's")
    if codes != archive["codes"]:
        fails.append("result codes differ from the oracle's")
    if counted != n_pairs:
        fails.append("the verifier did not count every pair")
    if mgr.lcl_hash != ledgers[-1]["hash"]:
        fails.append("the final hash differs from the oracle's")
    if native:
        report["engine_stats"] = bridge.stats()
    elif delta["crypto.verify.recompute"] \
            or delta["crypto.verify.cache-hit"] != checks.calls:
        fails.append("a verdict was recomputed or a check missed the cache")
    if fails:
        raise AssertionError(f"ledger-apply checks failed ({fails}): "
                             f"{report}")
    return report


def ledger_apply(n_payment_ledgers: int = APPLY_PAYMENT_LEDGERS,
                 device=None, n_accounts: int = APPLY_ACCOUNTS,
                 txs_per_ledger: int = APPLY_TXS_PER_LEDGER,
                 group: int = APPLY_GROUP, archive: dict = None) -> dict:
    """The ledger-apply phase: the oracle's chain (apply_archive), then
    three replays of it: the Python close on K-G's verdicts (hot_threshold
    1 << 62, the replay default), on K-B + K-T's (4, the bench's), and the
    native engine's close on K-G's where libsodium loads (elsewhere the
    phase checks that native close refuses to attach, and says so).  On
    the card each path must have run on its kernels alone.  `archive`: the
    oracle's chain made already (apply_archive with those sizes)."""
    if archive is None:
        archive = apply_archive(n_payment_ledgers, n_accounts,
                                txs_per_ledger, group)
    n = len(archive["ledgers"])
    report = {"phase": "ledger-apply", "signer": signer_name(),
              "cxdr": xdr_codec._cxdr is not None,
              "capply": native_apply._capply is not None,
              "libsodium": native_apply.libsodium_loads(),
              "ledgers": n, "payment_ledgers": n_payment_ledgers,
              "accounts": n_accounts, "txs_per_ledger": txs_per_ledger,
              "group": group, "signatures": len(archive["fixed"]),
              "corrupted": archive["corrupted"], "codes": archive["codes"],
              "final_hash": archive["ledgers"][-1]["hash"].hex(),
              "oracle": {k: archive[k] for k in (
                  "checked_verdicts", "sign_s", "oracle_close_s", "check_s",
                  "build_s")}}
    if archive["corrupted"] == 0:
        raise AssertionError("no signature was corrupted")
    on_card = device is None or torch.device(device).type == "cuda"
    for name, hot in APPLY_PATHS:
        run = apply_replay(archive, hot, device=device, group=group)
        if on_card:
            check_path_kernels(f"ledger-apply {name}", run["launches"],
                               run["counters"])
        report[name] = run
    if native_apply.native_apply_available():
        run = apply_replay(archive, 1 << 62, native=True, device=device,
                           group=group)
        if on_card:
            check_path_kernels("ledger-apply native, K-G", run["launches"],
                               run["counters"])
        report["native"] = run
    else:
        mgr = LedgerManager(archive["nid"], invariant_manager=None)
        mgr.start_new_ledger()
        if mgr.attach_native_close():
            raise AssertionError("native close attached without libsodium")
        report["native"] = {
            "ran": False,
            "why": ("the engine did not build" if native_apply._capply is None
                    else "libsodium does not load, so an engine cache miss "
                         "would reject a valid signature; every close ran "
                         "in Python")}
    return report


# -- catchup: the replay of a published archive through the port's catchup --

# the warm pass's target (bench.py:1874-1876), the runs (CatchupManager's
# keywords beyond accel=True; (a) its defaults: chunk 2,048, K-G, poll),
# the range workers of the parallel run
CATCHUP_WARM_TO = 127
CATCHUP_RUNS = (
    ("a", "K-G", {}),
    ("b", "K-B+K-T", {"accel_chunk": 8192, "accel_hot_threshold": 4}),
    ("c", "K-B+K-T", {"accel_chunk": 8192, "accel_hot_threshold": 4,
                      "accel_profile": "race"}))
CATCHUP_WORKERS = 3
CATCHUP_COUNTERS = SEAM_COUNTERS + (
    "catchup.preverify.not-dispatched", "catchup.preverify.race-lost",
    "catchup.preverify.late-seeded", "catchup.preverify.fallback",
    "catchup.preverify.sigs-total", "catchup.preverify.sigs-shipped")
CATCHUP_STATS = ("sigs_total", "sigs_shipped", "sigs_not_dispatched",
                 "sigs_race_lost", "sigs_late_seeded", "collect_fallbacks",
                 "collect_race_misses", "race_losses", "dispatch_s",
                 "dispatch_groups", "collect_wait_s")


def archive_tip(archive_dir: str) -> tuple:
    """(ledger, hash) of the published archive's tip: its HAS's current
    ledger and the last header entry of that checkpoint's ledger file."""
    fa = FileHistoryArchive(archive_dir)
    seq = fa.get_state().current_ledger
    last = X.LedgerHeaderHistoryEntry.from_xdr(
        fa.get_xdr_file(category_path(CATEGORY_LEDGER, seq))[-1])
    if last.header.ledgerSeq != seq:
        raise AssertionError(f"checkpoint {seq}'s ledger file ends at "
                             f"{last.header.ledgerSeq}")
    return seq, last.hash


class _TimedFallbacks:
    """The CPU verifies of signatures the verify cache missed
    (crypto.keys.verify_sig's recompute: libsodium, or its RFC 8032
    fallback), counted and timed while the context is open."""

    def __init__(self):
        self.calls, self.seconds = 0, 0.0

    def __enter__(self):
        self._orig = crypto_keys.sodium.verify_detached

        def verify_detached(*args):
            t0 = time.perf_counter()
            try:
                return self._orig(*args)
            finally:
                self.calls += 1
                self.seconds += time.perf_counter() - t0

        crypto_keys.sodium.verify_detached = verify_detached
        return self

    def __exit__(self, *exc):
        crypto_keys.sodium.verify_detached = self._orig


def join_device_workers(timeout: float = 300.0) -> None:
    """Wait for the preverify pipelines' device workers to end: a closed
    pipeline's worker runs the groups still queued (a poll-profile group
    that ripens after the replay) and then exits, so its launches are
    counted and their events complete before they are read."""
    deadline = time.monotonic() + timeout
    for t in threading.enumerate():
        if t.name == "preverify-device":
            t.join(max(0.0, deadline - time.monotonic()))


def catchup_run(archive_dir: str, nid: bytes, tip: tuple, kw: dict,
                device=None) -> dict:
    """One timed catchup_complete of the archive by CatchupManager(nid,
    APPLY_PASSPHRASE, accel=True, **kw) on `device` (None: the card),
    after keys.clear_verify_cache(), reset_registry() and with a fresh
    verifier (no pk cache, use counts or key tables), as a new catchup
    process has.  Launch counts are set to 0 just before and read after
    the pipeline's worker ended; each launch's CUDA-event time is summed
    a kernel.  The pipeline's worker thread records those events and waits
    for the GIL between an event and its launch, so the sums are upper
    bounds of the kernels' time (``kernel_ms_upper``).  Raises unless the
    replay ends on the archive's tip hash; on the card a device job that
    raised fails the catchup itself (PreverifyPipeline)."""
    crypto_keys.clear_verify_cache()
    metrics.reset_registry()
    ed25519._verifiers.clear()
    fa = FileHistoryArchive(archive_dir)
    cm = CatchupManager(nid, APPLY_PASSPHRASE, accel=True,
                        accel_device=device, **kw)
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    _cuda_build.launch_events = []
    try:
        with _TimedFallbacks() as fallbacks:
            t0 = time.perf_counter()
            mgr = cm.catchup_complete(fa)
            seconds = time.perf_counter() - t0
        join_device_workers()
        events = _cuda_build.launch_events
    finally:
        _cuda_build.launch_events = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    per_kernel = {}
    for name, start, end in events:
        per_kernel[name] = per_kernel.get(name, 0.0) + start.elapsed_time(end)
    kernel_ms = sum(per_kernel.values())
    reg = registry()
    counters = {c: reg.counter(c).value for c in CATCHUP_COUNTERS}
    dispatch = reg.timer("catchup.preverify.dispatch")
    n = mgr.last_closed_ledger_seq - 1
    run = {"settings": {"chunk": cm.accel_chunk,
                        "hot_threshold": cm.accel_hot_threshold,
                        "profile": cm.accel_profile or "poll",
                        "native": cm.native},
           "ledgers": n, "seconds": seconds, "ledgers_per_s": n / seconds,
           "final_ledger": mgr.last_closed_ledger_seq,
           "final_hash": mgr.lcl_hash.hex(),
           "offload_hit_rate": cm.offload_hit_rate(),
           "stats": {k: cm.stats.get(k, 0) for k in CATCHUP_STATS},
           "counters": counters,
           "dispatch_timer_count": dispatch.count,
           "fallback_verifies": fallbacks.calls,
           "fallback_verify_s": fallbacks.seconds,
           "launches": {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()},
           "kernel_ms_upper": per_kernel,
           "kernel_ms_total_upper": kernel_ms,
           "kernel_share_upper": kernel_ms / 1e3 / seconds}
    if (mgr.last_closed_ledger_seq, mgr.lcl_hash) != tip:
        raise AssertionError(f"catchup ended at {mgr.last_closed_ledger_seq} "
                             f"{mgr.lcl_hash.hex()}, not the archive's tip "
                             f"{tip[0]} {tip[1].hex()}: {run}")
    return run


def catchup_parallel(archive_dir: str, tip: tuple, accel: str,
                     workers: int = CATCHUP_WORKERS) -> dict:
    """`python -m stellar_core_tpu_torch catchup --parallel <workers>
    --accel <accel>` as a subprocess on a config naming the archive's
    network: range workers that assume state at interior checkpoints,
    replay their ranges and stitch.  Its report (--report) gives each
    range's stitch record; raises unless it exits 0 on the tip's hash and,
    with accel "cuda", unless every range launched a verify kernel and
    shipped some of its signatures' verdicts from the card."""
    with tempfile.TemporaryDirectory() as d:
        conf, out = os.path.join(d, "node.cfg"), os.path.join(d, "report.json")
        with open(conf, "w") as f:
            f.write(f'NETWORK_PASSPHRASE = "{APPLY_PASSPHRASE}"\n')
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=repo + (
            os.pathsep + os.environ["PYTHONPATH"]
            if os.environ.get("PYTHONPATH") else ""))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "stellar_core_tpu_torch", "catchup",
             "--conf", conf, "--archive", archive_dir, "--parallel",
             str(workers), "--accel", accel, "--report", out],
            capture_output=True, text=True, env=env, timeout=900)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"parallel catchup exited "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        with open(out) as f:
            report = json.load(f)
    ranges = [{k: r.get(k) for k in (
        "index", "seed_checkpoint", "replay_to", "final_ledger_seq",
        "ledgers_replayed", "wall_s", "ledgers_per_s",
        "sig_offload_hit_rate", "launches")} for r in report["ranges"]]
    run = {"workers": workers, "accel": accel, "seconds": seconds,
           "ledgers_per_s": (tip[0] - 1) / seconds,
           "orchestrator_ledgers_per_s": report["ledgers_per_s"],
           "orchestrator_wall_s": report["wall_s"],
           "stitches_verified": report["stitches_verified"],
           "steals": report["steals"],
           "final_ledger": report["final_ledger_seq"],
           "final_hash": report["final_hash"], "ranges": ranges}
    if (report["final_ledger_seq"], report["final_hash"]) \
            != (tip[0], tip[1].hex()):
        raise AssertionError(f"parallel catchup did not end on the "
                             f"archive's tip: {run}")
    if accel == "cuda" and not all(
            r["sig_offload_hit_rate"] > 0 and sum(r["launches"].values())
            for r in ranges):
        raise AssertionError(f"a range worker did not verify on the card: "
                             f"{ranges}")
    return run


def catchup_phase(archive: dict, archive_dir: str, device=None) -> dict:
    """The catchup phase: the oracle's chain as apply_archive published it
    (its tip must be the oracle's last ledger), a warm pass that is not
    timed (catchup_complete to CATCHUP_WARM_TO at the bench's settings),
    then the timed runs (a)-(c) (catchup_run) and (d), the parallel
    catchup through the command line.  On the card run (a) must have
    launched K-G alone and runs (b) and (c) K-B and K-T, and run (c), whose
    collects wait for the card within the race's budget, must have
    verified no group on the CPU."""
    nid = archive["nid"]
    tip = archive_tip(archive_dir)
    last = archive["ledgers"][-1]
    if tip != (last["seq"], last["hash"]):
        raise AssertionError(f"the archive's tip {tip[0]} {tip[1].hex()} is "
                             f"not the oracle's last ledger")
    on_card = device is None or torch.device(device).type == "cuda"
    report = {"phase": "catchup", "signer": signer_name(),
              "libsodium": native_apply.libsodium_loads(),
              "native": ("on" if native_apply.native_apply_available()
                         else "off: libsodium does not load, so every "
                              "close runs in Python (ledger-apply)"),
              "archive_ledgers": tip[0], "archive_hash": tip[1].hex(),
              "checkpoints": len(archive["published"]),
              "signatures": len(archive["fixed"]),
              "corrupted": archive["corrupted"]}
    t0 = time.perf_counter()
    crypto_keys.clear_verify_cache()
    warm = CatchupManager(nid, APPLY_PASSPHRASE, accel=True,
                          accel_device=device, **CATCHUP_RUNS[1][2])
    if warm.catchup_complete(FileHistoryArchive(archive_dir),
                             to_ledger=CATCHUP_WARM_TO) \
            .last_closed_ledger_seq != CATCHUP_WARM_TO:
        raise AssertionError("the warm pass did not reach its target")
    join_device_workers()
    report["warm_s"] = time.perf_counter() - t0
    for name, path, kw in CATCHUP_RUNS:
        run = catchup_run(archive_dir, nid, tip, kw, device)
        if on_card:
            check_path_kernels(f"catchup ({name}) {path}", run["launches"],
                               run["counters"])
            if run["settings"]["profile"] == "race" \
                    and run["stats"]["collect_fallbacks"]:
                raise AssertionError(f"catchup ({name}): groups verified on "
                                     f"the CPU: {run['stats']}")
        report[name] = run
    report["d"] = catchup_parallel(
        archive_dir, tip, "cuda" if on_card else "cpu")
    return report


# -- admission and consensus: the live node's intake and ledger closes --------

# bench.py's on-device admission row (:803-808): AdmissionCampaign's knobs
# and its run; the oracle is the same campaign and seed with accel off
ADMISSION_KNOBS = {"n_accounts": 4000, "batch_size": 256,
                   "max_tx_set_ops": 500, "max_backlog": 2000}
ADMISSION_RUNS = ((3, 500),)
# bench.py's sustained and 2x overload campaign (:826-868): 100,000
# seed-derived accounts over BucketListDB, a tx set of 500 operations
SUSTAINED_ACCOUNTS, SUSTAINED_CAP, SUSTAINED_BACKLOG = 100_000, 500, 2000
SUSTAINED_RUNS = ((4, SUSTAINED_CAP), (6, 2 * SUSTAINED_CAP))
# a standalone validator: a singleton quorum set, 10,000 pool accounts,
# bursts of 1,000 payments through Herder.recv_transaction, a tx set of
# 1,000 operations (AdmissionCampaign's default max_tx_set_ops)
CONSENSUS_ACCOUNTS, CONSENSUS_LEDGERS, CONSENSUS_BURST = 10_000, 10, 1000
CONSENSUS_TX_SET, CONSENSUS_BATCH, CONSENSUS_BACKLOG = 1000, 256, 2000
CONSENSUS_PASSPHRASE = "chip smoke consensus net"
CONSENSUS_SEED = 7
# the longest the warm batch may take: PreverifyPipeline's first collect
WARM_TIMEOUT_S = 180.0
ADMISSION_STATS = ("submitted", "admitted", "rejected", "overload",
                   "prefiltered", "sync_path", "batches", "sigs_offloaded",
                   "sigs_total", "sigs_shipped", "sigs_not_dispatched",
                   "sigs_race_lost", "collect_fallbacks", "race_losses",
                   "dispatch_groups", "dispatch_s", "collect_wait_s")


# seed -> (pk, sk) of every key derived under _HostCrypto (see there)
_KEYPAIRS = {}


class _HostCrypto:
    """The host's Ed25519 calls while the context is open: key derivations
    (memoized for the script's life in _KEYPAIRS: a seed-derived account
    pool derives an account's key again at each use, and the oracle and
    the card's run derive the same keys; the RFC 8032 fallback takes
    tens of times libsodium's time a key), signatures made by the clients,
    and verifications (each signature the card did not answer: the sync
    path's lone arrivals, batches below accel_min_sigs, a lost race),
    counted and timed."""

    def __init__(self):
        self.keys, self.keys_s = 0, 0.0
        self.signs, self.sign_s = 0, 0.0
        self.verifies, self.verify_s = 0, 0.0
        self._memo = _KEYPAIRS

    def __enter__(self):
        self._orig = (sodium.sign_seed_keypair, sodium.sign_detached,
                      sodium.verify_detached)
        keypair, sign, verify = self._orig

        def sign_seed_keypair(seed):
            got = self._memo.get(seed)
            if got is None:
                t0 = time.perf_counter()
                got = self._memo[seed] = keypair(seed)
                self.keys += 1
                self.keys_s += time.perf_counter() - t0
            return got

        def sign_detached(*args):
            t0 = time.perf_counter()
            try:
                return sign(*args)
            finally:
                self.signs += 1
                self.sign_s += time.perf_counter() - t0

        def verify_detached(*args):
            t0 = time.perf_counter()
            try:
                return verify(*args)
            finally:
                self.verifies += 1
                self.verify_s += time.perf_counter() - t0

        (sodium.sign_seed_keypair, sodium.sign_detached,
         sodium.verify_detached) = sign_seed_keypair, sign_detached, \
            verify_detached
        return self

    def __exit__(self, *exc):
        (sodium.sign_seed_keypair, sodium.sign_detached,
         sodium.verify_detached) = self._orig

    def snapshot(self) -> dict:
        return {"keys": self.keys, "keys_s": self.keys_s,
                "signs": self.signs, "sign_s": self.sign_s,
                "cpu_verifies": self.verifies, "cpu_verify_s": self.verify_s}


class _BatchLog:
    """Each batch an AdmissionPipeline flushes: its signatures, whether the
    pipeline had warmed when it chose where the batch verifies, and whether
    the batch went to the card (its signatures counted as offloaded)."""

    def __init__(self, pipe):
        self.batches = []
        flush = pipe._flush

        def logged():
            sigs, offloaded = pipe._pending_sigs, pipe.stats["sigs_offloaded"]
            flush()
            if sigs:
                self.batches.append(
                    (sigs, pipe._warmed,
                     pipe.stats["sigs_offloaded"] > offloaded))

        pipe._flush = logged


def wait_warm(pipe) -> float:
    """Seconds until the pipeline's warm batch (dispatched when it was
    built) has its verdicts; the pipeline takes them at its next flush.
    Raises when they have not come within WARM_TIMEOUT_S: the pipeline
    never warmed, and would admit on the CPU for the whole run."""
    timeout = WARM_TIMEOUT_S
    t0 = time.perf_counter()
    while not pipe._preverify.job_done(pipe._warm_id):
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"the admission pipeline never warmed: its "
                                 f"warm batch had no verdicts after "
                                 f"{timeout} s")
        time.sleep(0.005)
    return time.perf_counter() - t0


def check_card_use(what: str, pipe, log: _BatchLog, launches: dict) -> dict:
    """The card-usage limits of an accel admission run: the pipeline
    warmed, every batch of at least accel_min_sigs signatures flushed
    after it warmed went to the card, signatures were offloaded, K-G
    launched (on the card; the plain versions count no launch), and no
    collect lost its race or fell back to the CPU.
    Returns the batch counts it checked; raises on any limit missed."""
    stats = pipe.stats
    eligible = [b for b in log.batches
                if b[1] and b[0] >= pipe.accel_min_sigs]
    undispatched = sum(1 for b in eligible if not b[2])
    counts = {"warmed": pipe._warmed, "batches": len(log.batches),
              "batches_before_warm": sum(1 for b in log.batches if not b[1]),
              "eligible_batches": len(eligible),
              "eligible_not_dispatched": undispatched,
              "batches_below_min": sum(1 for b in log.batches
                                       if b[0] < pipe.accel_min_sigs)}
    faults = []
    if not pipe._warmed:
        faults.append("the pipeline never warmed")
    if undispatched:
        faults.append(f"{undispatched} batches of >= {pipe.accel_min_sigs} "
                      f"signatures after warmup were not dispatched")
    if not stats.get("sigs_offloaded"):
        faults.append("no signature was offloaded")
    if pipe._preverify.devices[0].type == "cuda" and not launches.get("K-G"):
        faults.append("K-G never launched")
    if stats.get("race_losses") or stats.get("collect_fallbacks"):
        faults.append(f"{stats.get('race_losses', 0)} races lost, "
                      f"{stats.get('collect_fallbacks', 0)} collects fell "
                      f"back to the CPU")
    if faults:
        raise AssertionError(f"{what}: {'; '.join(faults)}: {counts} "
                             f"{dict(stats)}")
    return counts


def _stats(pipe) -> dict:
    return {k: pipe.stats[k] for k in ADMISSION_STATS if k in pipe.stats}


def admission_campaign(accel: bool, runs, device=None, workdir=None,
                       accel_min_sigs=None, **knobs) -> dict:
    """One AdmissionCampaign(accel=accel, accel_device=device, workdir,
    **knobs), its pipeline's accel_min_sigs set where given (the campaign
    keeps the pipeline's default, 64), and its runs (n_ledgers,
    offered_per_ledger), after
    keys.clear_verify_cache() and reset_registry(): each run's report,
    every status count, every closed ledger's hash, the admission stats,
    the host's Ed25519 calls (in the install, in all runs and in each),
    the batches' log and, with accel, the wait for the warm batch (set-up,
    before the runs) and the launches of the runs (counts set to 0 just
    before them)."""
    from stellar_core_tpu_torch.simulation.loadgen import AdmissionCampaign
    crypto_keys.clear_verify_cache()
    metrics.reset_registry()
    with _HostCrypto() as host:
        t0 = time.perf_counter()
        c = AdmissionCampaign(workdir=workdir, accel=accel,
                              accel_device=device, **knobs)
        install_s = time.perf_counter() - t0
        if accel_min_sigs is not None:
            c.admission.accel_min_sigs = accel_min_sigs
        try:
            closes = []
            close = c.mgr.close_ledger

            def recorded(*args, **kw):
                arts = close(*args, **kw)
                closes.append(c.mgr.lcl_hash.hex())
                return arts

            c.mgr.close_ledger = recorded
            log = _BatchLog(c.admission)
            warm_s = wait_warm(c.admission) if accel else None
            snaps = [host.snapshot()]
            for fn in KERNEL_WRAPPERS.values():
                fn.launches = 0
            reports = []
            for n, offered in runs:
                reports.append(c.run(n, offered))
                snaps.append(host.snapshot())
            launches = {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}
        finally:
            c.close()

    def delta(a, b):
        return {k: b[k] - a[k] for k in b}

    return {"campaign": c, "install_s": install_s, "warm_s": warm_s,
            "reports": reports, "statuses": dict(c.statuses),
            "closes": closes, "stats": _stats(c.admission), "log": log,
            "launches": launches, "host": delta(snaps[0], snaps[-1]),
            "host_runs": [delta(a, b) for a, b in zip(snaps, snaps[1:])],
            "host_install": snaps[0]}


def _campaign_rates(rep: dict, host: dict) -> dict:
    """A campaign run's rates: applied tx/s over its wall time, and over
    that time less the clients' key derivations and signing, which run in
    the loop (bench.py's sustained_tps counts them too; where libsodium
    is missing the RFC 8032 fallback makes them a large share)."""
    client_s = host["keys_s"] + host["sign_s"]
    return {"applied": rep["applied"], "wall_s": rep["wall_s"],
            "tps": rep["sustained_tps"], "client_crypto_s": client_s,
            "tps_net_of_clients": rep["applied"] / max(
                1e-9, rep["wall_s"] - client_s)}


def admission_phase(device=None, knobs=None, runs=ADMISSION_RUNS,
                    sustained_accounts=SUSTAINED_ACCOUNTS,
                    sustained_runs=SUSTAINED_RUNS,
                    sustained_cap=SUSTAINED_CAP,
                    sustained_backlog=SUSTAINED_BACKLOG,
                    accel_min_sigs=None) -> dict:
    """The admission phase: (a) bench.py's on-device admission row, an
    AdmissionCampaign with accel on `device` (None: the card) against the
    same campaign and seed with accel off (every status count and every
    closed ledger's hash equal); (b) its sustained and 2x overload
    campaign over BucketListDB in a temporary directory, accel on, held
    to the bench's bounds (peak queue depth at most 4 x the cap, peak
    admission depth at most max_backlog).  Both held to check_card_use."""
    knobs = dict(ADMISSION_KNOBS if knobs is None else knobs)
    oracle = admission_campaign(False, runs, **knobs)
    card = admission_campaign(True, runs, device,
                              accel_min_sigs=accel_min_sigs, **knobs)
    rep = card["reports"][-1]
    a = {"knobs": knobs, "runs": runs, "install_s": card["install_s"],
         "warm_s": card["warm_s"], "statuses": card["statuses"],
         "ledgers": len(card["closes"]), "last_hash": card["closes"][-1],
         "equals_oracle": True, "stats": card["stats"],
         "oracle_stats": oracle["stats"], "launches": card["launches"],
         "host": card["host"], "oracle_host": oracle["host"],
         **_campaign_rates(rep, card["host"]),
         "oracle_tps": oracle["reports"][-1]["sustained_tps"],
         **{k: rep.get(k) for k in ("admission_p50_us", "admission_p99_us",
                                    "batches", "batch_size_p50",
                                    "batch_size_p99")}}
    if (card["statuses"], card["closes"]) \
            != (oracle["statuses"], oracle["closes"]):
        raise AssertionError(f"admission (a) differs from its accel-off "
                             f"oracle: {card['statuses']} {card['closes']} "
                             f"!= {oracle['statuses']} {oracle['closes']}")
    a["batch_checks"] = check_card_use("admission (a)", card["campaign"]
                                       .admission, card["log"],
                                       card["launches"])

    with tempfile.TemporaryDirectory(prefix="chip-smoke-admission-") as d:
        run = admission_campaign(True, sustained_runs, device, workdir=d,
                                 accel_min_sigs=accel_min_sigs,
                                 n_accounts=sustained_accounts,
                                 max_tx_set_ops=sustained_cap,
                                 max_backlog=sustained_backlog)
    pipe = run["campaign"].admission
    rep1, rep2 = run["reports"][0], run["reports"][-1]
    b = {"accounts": sustained_accounts, "cap": sustained_cap,
         "runs": sustained_runs, "install_s": run["install_s"],
         "install_keys_s": run["host_install"]["keys_s"],
         "warm_s": run["warm_s"], "statuses": run["statuses"],
         "ledgers": len(run["closes"]), "stats": run["stats"],
         "launches": run["launches"], "host": run["host"],
         "sustained": _campaign_rates(rep1, run["host_runs"][0]),
         "overload": {**_campaign_rates(rep2, run["host_runs"][-1]),
                      **{k: rep2.get(k) for k in (
                          "admission_p50_us", "admission_p90_us",
                          "admission_p99_us", "batches", "batch_size_p50",
                          "batch_size_p99", "batch_size_max",
                          "peak_queue_depth", "peak_admission_depth",
                          "backpressure_engaged", "peak_decoded_entries")}},
         "shed": pipe.stats["rejected"],
         "prefiltered": pipe.stats["prefiltered"],
         "try_again_later": run["statuses"].get(
             AddResult.STATUS_TRY_AGAIN_LATER, 0),
         "collect_wait_s": pipe.stats.get("collect_wait_s", 0.0)}
    if rep2["peak_queue_depth"] > 4 * sustained_cap:
        raise AssertionError(f"admission (b): the tx queue grew past its "
                             f"surge bound under 2x overload: {b}")
    if rep2["peak_admission_depth"] > pipe.max_backlog:
        raise AssertionError(f"admission (b): the admission backlog grew "
                             f"past max_backlog under overload: {b}")
    b["batch_checks"] = check_card_use("admission (b)", pipe, run["log"],
                                       run["launches"])
    return {"phase": "admission", "signer": signer_name(), "a": a, "b": b}


def consensus_run(accel: bool, device=None, n_accounts=CONSENSUS_ACCOUNTS,
                  n_ledgers=CONSENSUS_LEDGERS, burst=CONSENSUS_BURST,
                  tx_set=CONSENSUS_TX_SET, batch_size=CONSENSUS_BATCH,
                  max_backlog=CONSENSUS_BACKLOG, **knobs) -> dict:
    """A standalone validator closing `n_ledgers` ledgers by SCP: a Herder
    on a VIRTUAL_TIME clock with a singleton quorum set, admission enabled
    (accel on `device` where `accel`), the ledger's maxTxSetSize `tx_set`,
    `n_accounts` seed-derived accounts installed by LoadGenerator.  Before
    each trigger a burst of `burst` payments (distinct sources) goes
    through recv_transaction and the admission drains; then the clock
    cranks until ledger_closed_hook fires (the first trigger is
    bootstrap()'s).  After keys.clear_verify_cache() and reset_registry();
    launch counts set to 0 just before the first burst (after the warm
    batch, waited for with accel).  Returns each ledger's hash, tx-set
    hash, result set hash, applied count and the queue left after it, the
    statuses, the herder's state transitions, the admission stats, the
    host's Ed25519 calls and the times."""
    from stellar_core_tpu_torch.herder.herder import Herder
    from stellar_core_tpu_torch.scp.quorum import singleton_qset
    from stellar_core_tpu_torch.simulation.loadgen import (LoadGenerator,
                                                           SeedAccountPool)
    from stellar_core_tpu_torch.util.clock import ClockMode, VirtualClock
    crypto_keys.clear_verify_cache()
    metrics.reset_registry()
    nid = sha256(CONSENSUS_PASSPHRASE.encode())
    with _HostCrypto() as host:
        t0 = time.perf_counter()
        clock = VirtualClock(ClockMode.VIRTUAL_TIME)
        lm = LedgerManager(nid, invariant_manager=None)
        lm.start_new_ledger()
        lm.lcl_header.maxTxSetSize = tx_set
        pool = SeedAccountPool(n_accounts, seed=CONSENSUS_SEED)
        LoadGenerator(lm, seed=CONSENSUS_SEED, clock=clock) \
            .install_account_pool(pool)
        node = SecretKey(sha256(b"chip smoke consensus validator"))
        herder = Herder(clock, lm, node,
                        singleton_qset(node.public_key.ed25519))
        herder.enable_admission(accel=accel, accel_device=device,
                                batch_size=batch_size,
                                max_backlog=max_backlog, **knobs)
        pipe = herder.admission
        log = _BatchLog(pipe)
        setup_s = time.perf_counter() - t0
        transitions = []
        set_state = herder._set_state

        def recorded_state(state, why):
            if state != herder.state:
                transitions.append((herder.state, state, why))
            set_state(state, why)

        herder._set_state = recorded_state
        closed = []
        herder.ledger_closed_hook = lambda arts: closed.append(
            (time.perf_counter(), arts))
        triggered = []
        trigger = herder.trigger_next_ledger

        def timed_trigger(seq):
            triggered.append((seq, time.perf_counter()))
            trigger(seq)

        herder.trigger_next_ledger = timed_trigger
        rng = random.Random(CONSENSUS_SEED)
        try:
            warm_s = wait_warm(pipe) if accel else None
            for fn in KERNEL_WRAPPERS.values():
                fn.launches = 0
            before = host.snapshot()
            statuses, ledgers = {}, []
            admit_s = sign_s = 0.0
            t_run = time.perf_counter()
            for k in range(n_ledgers):
                t0 = time.perf_counter()
                frames = [build_tx(nid, pool.secret(i), pool.next_seq(i),
                                   [native_payment_op(pool.account_id(
                                       rng.randrange(n_accounts)), 100)],
                                   fee=100 + rng.randrange(200))
                          for i in rng.sample(range(n_accounts), burst)]
                t1 = time.perf_counter()
                sign_s += t1 - t0
                for f in frames:
                    code = herder.recv_transaction(f).code
                    statuses[code] = statuses.get(code, 0) + 1
                pipe.drain()
                admit_s += time.perf_counter() - t1
                if k == 0:
                    herder.bootstrap()
                cranks = 0
                while len(closed) < k + 1:
                    if cranks == 100_000:
                        raise AssertionError(f"ledger {k + 1} of the "
                                             f"validator did not close")
                    clock.crank()
                    cranks += 1
                at, arts = closed[-1]
                header = arts.header_entry.header
                results = arts.result_entry.txResultSet
                ledgers.append({
                    "seq": header.ledgerSeq, "hash": lm.lcl_hash.hex(),
                    "tx_set_hash": header.scpValue.txSetHash.hex(),
                    "result_set_hash": sha256(results.to_xdr()).hex(),
                    "applied": len(results.results),
                    "queued_after": herder.tx_queue.size,
                    "close_time": header.scpValue.closeTime,
                    "externalize_s": at - triggered[-1][1]})
            run_s = time.perf_counter() - t_run
            launches = {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}
            after = host.snapshot()
        finally:
            pipe.close()
    return {"ledgers": ledgers, "statuses": statuses,
            "transitions": transitions, "state": herder.state,
            "stats": _stats(pipe), "log": log, "pipe": pipe,
            "launches": launches, "setup_s": setup_s, "warm_s": warm_s,
            "run_s": run_s, "client_sign_s": sign_s, "admit_s": admit_s,
            "admitted": pipe.stats["admitted"],
            "host": {k: after[k] - before[k] for k in after}}


def _validator_view(run: dict) -> dict:
    """What of a consensus_run two runs of one script must share."""
    return {"ledgers": [{k: v for k, v in l.items() if k != "externalize_s"}
                        for l in run["ledgers"]],
            "statuses": run["statuses"], "transitions": run["transitions"],
            "admitted": run["admitted"]}


def consensus_phase(device=None, **kw) -> dict:
    """The consensus phase: consensus_run with accel on `device` (None:
    the card) against the same script with accel off.  Every ledger's
    hash, tx-set hash and result set equal to the oracle's, every admitted
    transaction applied (no queue left after a close), and
    check_card_use's limits."""
    oracle = consensus_run(False, **kw)
    card = consensus_run(True, device, **kw)
    if _validator_view(card) != _validator_view(oracle):
        raise AssertionError(f"the validator's ledgers differ from its "
                             f"accel-off oracle: {_validator_view(card)} != "
                             f"{_validator_view(oracle)}")
    left = [l for l in card["ledgers"] if l["queued_after"]]
    applied = sum(l["applied"] for l in card["ledgers"])
    if left or applied != card["admitted"]:
        raise AssertionError(f"the validator left admitted transactions "
                             f"unapplied: {applied} applied of "
                             f"{card['admitted']}; {left}")
    checks = check_card_use("consensus", card["pipe"], card["log"],
                            card["launches"])
    lat = [l["externalize_s"] for l in card["ledgers"]]
    n = len(card["ledgers"])
    return {"phase": "consensus", "signer": signer_name(),
            "ledgers": n, "last_hash": card["ledgers"][-1]["hash"],
            "applied": applied, "equals_oracle": True,
            "statuses": card["statuses"], "transitions": card["transitions"],
            "setup_s": card["setup_s"], "warm_s": card["warm_s"],
            "run_s": card["run_s"], "ledgers_per_s": n / card["run_s"],
            "consensus_s": sum(lat), "ledgers_per_consensus_s": n / sum(lat),
            "client_sign_s": card["client_sign_s"],
            "admit_s": card["admit_s"],
            "admitted_tx_per_s": card["admitted"] / card["admit_s"],
            "oracle_admitted_tx_per_s": oracle["admitted"]
            / oracle["admit_s"],
            "oracle_run_s": oracle["run_s"],
            "externalize_s": lat, "stats": card["stats"],
            # the host's signatures beyond the clients': SCP envelopes
            "scp_envelope_signs": card["host"]["signs"]
            - sum(card["statuses"].values()),
            "launches": card["launches"], "host": card["host"],
            "oracle_host": oracle["host"], "batch_checks": checks}


# -- a node served by `run`, and validators over the overlay ------------------

# a node served by `run`: a tx set of 1,000 operations, admission batches
# of 256 signatures and a backlog of 2,000, 10,000 accounts made by its own
# transactions (the consensus phase's pool, whose keys are memoized), a
# burst of 2,000 payments posted to /tx by NODE_CLIENTS threads
NODE_PASSPHRASE = "chip smoke node net"
NODE_ACCOUNTS, NODE_BURST, NODE_TX_SET = 10_000, 2000, 1000
NODE_BATCH, NODE_BACKLOG, NODE_CHUNK = 256, 2000, 2048
NODE_FUNDED = 100                   # accounts one funder's transaction makes
NODE_CLIENTS = 32
# the deadline of a partial batch: one node's /tx intake runs at about a
# thousand transactions a second, so the default 50 ms flushes batches of
# 30-50 signatures, under accel_min_sigs (64), all verified on the CPU;
# 250 ms (inside the 0.5 s admission-latency objective) lets them fill
NODE_FLUSH_DELAY_S = 0.25
NODE_CHECKPOINTS = 2
NODE_TIMEOUT_S = 300.0
NODE_BALANCE = 10_000_000_000
# /tx answers that are a reasoned rejection (tx_queue.AddResult's statuses)
NODE_REJECTIONS = ("ERROR", "DUPLICATE", "TRY_AGAIN_LATER", "BANNED",
                   "FILTERED")
# three validators with a 2-of-3 quorum set (SDF's testnet:
# docs/stellar-core_testnet.cfg names three SDF validators), a burst of
# 1,000 payments at one of them, 10 ledgers closed by SCP
NETWORK_PASSPHRASE = "chip smoke network net"
NETWORK_VALIDATORS, NETWORK_THRESHOLD = 3, 2
NETWORK_ACCOUNTS, NETWORK_LEDGERS, NETWORK_BURST = 10_000, 10, 1000
NETWORK_TX_SET, NETWORK_BATCH, NETWORK_BACKLOG = 1000, 256, 2000


def x25519_path() -> str:
    """Which X25519 the overlay's handshakes run on."""
    return "libsodium" if sodium.available() else \
        "rfc7748 (crypto/rfc7748.py; libsodium is missing)"


def _close_record(arts) -> dict:
    """A closed ledger: its seq, hash, tx-set hash, result set hash, the
    number of transactions applied and the hashes of those that
    succeeded."""
    header = arts.header_entry.header
    results = arts.result_entry.txResultSet
    return {"seq": header.ledgerSeq, "hash": arts.header_entry.hash.hex(),
            "tx_set_hash": header.scpValue.txSetHash.hex(),
            "result_set_hash": sha256(results.to_xdr()).hex(),
            "applied": len(results.results),
            "succeeded": [pair.transactionHash for pair in results.results
                          if pair.result.result.switch.name == "txSUCCESS"]}


def node_config(path: str, archive: str, http_port: int, accel: str,
                batch_size: int = NODE_BATCH, max_backlog: int = NODE_BACKLOG,
                chunk: int = NODE_CHUNK,
                flush_delay_s: float = NODE_FLUSH_DELAY_S) -> str:
    """Write the node's TOML config to `path`, its DATABASE and buckets
    beside it; returns the path."""
    state = os.path.dirname(os.path.abspath(path))
    with open(path, "w") as f:
        f.write(f'NETWORK_PASSPHRASE = "{NODE_PASSPHRASE}"\n'
                f'NODE_SEED = "{SecretKey(sha256(b"chip smoke node")).to_strkey_seed()}"\n'
                "NODE_IS_VALIDATOR = true\n"
                "RUN_STANDALONE = true\n"
                "PEER_PORT = 0\n"
                f"HTTP_PORT = {http_port}\n"
                f'ACCEL = "{accel}"\n'
                f"ACCEL_CHUNK_SIZE = {chunk}\n"
                "ADMISSION = true\n"
                f"ADMISSION_BATCH_SIZE = {batch_size}\n"
                f"ADMISSION_FLUSH_DELAY_S = {flush_delay_s}\n"
                f"ADMISSION_MAX_BACKLOG = {max_backlog}\n"
                "ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING = true\n"
                f'DATABASE = "{state}/node.db"\n'
                f'BUCKET_DIR_PATH = "{state}/buckets"\n'
                "\n[HISTORY.local]\n"
                f'get = "{archive}"\n'
                f'put = "{archive}"\n')
    return path


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port: int, path: str, timeout: float = 30.0) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return json.loads(r.read())


class _NodeRecorder:
    """The Application that `run` builds, recorded as it is built: its
    admission pipeline's batch log (accel_min_sigs set where given) and
    each ledger it closes (_close_record), appended on the main thread."""

    def __init__(self, accel_min_sigs=None):
        self.app = None
        self.log = None
        self.closes = []
        self.accel_min_sigs = accel_min_sigs

    def __enter__(self):
        from stellar_core_tpu_torch.main import application as app_mod
        self._mod, self._base = app_mod, app_mod.Application
        rec = self

        class Recorded(self._base):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                pipe = self.herder.admission
                if pipe is not None:
                    if rec.accel_min_sigs is not None:
                        pipe.accel_min_sigs = rec.accel_min_sigs
                    rec.log = _BatchLog(pipe)
                hook = self.herder.ledger_closed_hook

                def closed(arts):
                    hook(arts)
                    rec.closes.append(_close_record(arts))

                self.herder.ledger_closed_hook = closed
                rec.app = self

        app_mod.Application = Recorded
        return self

    def __exit__(self, *exc):
        self._mod.Application = self._base

    def applied(self) -> dict:
        """{transaction hash: the ledger that applied it with success}."""
        return {h: c["seq"] for c in list(self.closes)
                for h in c["succeeded"]}


def _wait(what: str, pred, timeout: float, stop: threading.Event,
          every: float = 0.02) -> None:
    t0 = time.perf_counter()
    while not pred():
        if stop.is_set():
            raise AssertionError(f"{what}: the node stopped")
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(every)


def _post_all(port: int, frames, clients: int) -> list:
    """Each frame's envelope posted to /tx, `clients` requests at a time;
    the answers in order."""
    def post(f):
        return _http(port, "/tx?blob=" + f.envelope.to_xdr().hex())

    with ThreadPoolExecutor(clients) as ex:
        return list(ex.map(post, frames))


def _submit_until_applied(port: int, rec: _NodeRecorder, frames,
                          timeout: float, stop: threading.Event) -> dict:
    """Post the set-up transactions to /tx, again after a ledger closes
    where the queue was full (TRY_AGAIN_LATER), until every one is
    applied; {content hash: ledger}."""
    want = {f.content_hash(): f for f in frames}
    t0 = time.perf_counter()
    todo = list(frames)
    while todo:
        answers = _post_all(port, todo, NODE_CLIENTS)
        bad = [a for a in answers
               if a.get("status") not in ("PENDING", "TRY_AGAIN_LATER",
                                          "DUPLICATE")]
        if bad:
            raise AssertionError(f"node: a set-up transaction was "
                                 f"refused: {bad[:3]}")
        retry = [f for f, a in zip(todo, answers)
                 if a["status"] == "TRY_AGAIN_LATER"]
        seen = len(rec.closes)
        _wait("node: set-up transactions applied",
              lambda: (len(rec.closes) > seen if retry else
                       want.keys() <= rec.applied().keys()),
              timeout - (time.perf_counter() - t0), stop)
        todo = retry
    applied = rec.applied()
    return {h: applied[h] for h in want}


def _node_client(port: int, rec: _NodeRecorder, out: dict,
                 stop: threading.Event, n_accounts: int, burst: int,
                 tx_set: int, timeout: float) -> None:
    """The node's clients, on a helper thread: wait for /info, grow the tx
    set over /upgrades, create the accounts over /tx, wait for the warm
    batch, then (launch counts set to 0) post the burst and wait for every
    accepted payment applied and NODE_CHECKPOINTS checkpoints published,
    the last at or after the ledger of the last payment.  Fills `out`;
    stops the node by SIGTERM once it answered."""
    from stellar_core_tpu_torch.simulation.loadgen import SeedAccountPool
    up = False
    try:
        t0 = time.perf_counter()

        def answers():
            try:
                return _http(port, "/info", timeout=2.0) is not None
            except OSError:
                return False

        _wait("node: /info", lambda: rec.app is not None and answers(),
              120.0, stop, every=0.05)
        up = True
        out["start_s"] = time.perf_counter() - t0
        app = rec.app
        pipe = app.herder.admission
        if pipe is None:
            raise AssertionError("node: admission is off")
        nid = app.network_id
        _http(port, f"/upgrades?mode=set&upgradetime=0&maxtxsetsize={tx_set}")
        _wait("node: the tx set upgrade",
              lambda: app.lm.lcl_header.maxTxSetSize == tx_set, 60.0, stop)

        # the accounts, made by the node's own transactions: root funds
        # one funder an NODE_FUNDED accounts, each funder makes them
        t1 = time.perf_counter()
        pool = SeedAccountPool(n_accounts, seed=CONSENSUS_SEED)
        n_funders = -(-n_accounts // NODE_FUNDED)
        if n_funders > 100:
            raise ValueError("node: at most 100 funders (one transaction)")
        funders = [SecretKey(sha256(b"chip smoke node funder %d" % j))
                   for j in range(n_funders)]
        root = app.lm.root_account_secret()
        root_seq = app.lm.root.get_entry(X.LedgerKey.account(
            X.LedgerKeyAccount(accountID=X.AccountID.ed25519(
                root.public_key.ed25519))).to_xdr()).data.value.seqNum
        fund = build_tx(nid, root, root_seq + 1, [
            create_account_op(X.AccountID.ed25519(f.public_key.ed25519),
                              (NODE_FUNDED + 1) * NODE_BALANCE)
            for f in funders])
        at = _submit_until_applied(port, rec, [fund], timeout, stop)
        funder_seq = at[fund.content_hash()] << 32
        makes = [build_tx(nid, f, funder_seq + 1, [
            create_account_op(pool.account_id(i), NODE_BALANCE)
            for i in range(j * NODE_FUNDED,
                           min(n_accounts, (j + 1) * NODE_FUNDED))])
            for j, f in enumerate(funders)]
        at = _submit_until_applied(port, rec, makes, timeout, stop)
        seqs = {}
        for j, f in enumerate(makes):
            for i in range(j * NODE_FUNDED,
                           min(n_accounts, (j + 1) * NODE_FUNDED)):
                seqs[i] = at[f.content_hash()] << 32
        out["accounts_s"] = time.perf_counter() - t1
        out["accounts_ledger"] = max(at.values())
        out["warm_s"] = wait_warm(pipe)

        # the burst
        rng = random.Random(CONSENSUS_SEED + 1)
        t2 = time.perf_counter()
        frames = [build_tx(nid, pool.secret(i), seqs[i] + 1,
                           [native_payment_op(pool.account_id(
                               rng.randrange(n_accounts)), 100)],
                           fee=100 + rng.randrange(200))
                  for i in rng.sample(range(n_accounts), burst)]
        out["client_sign_s"] = time.perf_counter() - t2
        for fn in KERNEL_WRAPPERS.values():
            fn.launches = 0
        first = len(rec.closes)
        t3 = time.perf_counter()
        answers = _post_all(port, frames, NODE_CLIENTS)
        out["post_s"] = time.perf_counter() - t3
        statuses = {}
        for a in answers:
            statuses[a.get("status")] = statuses.get(a.get("status"), 0) + 1
        out["statuses"] = statuses
        unreasoned = [a for a in answers if a.get("status") != "PENDING"
                      and not (a.get("status") in NODE_REJECTIONS
                               and (a.get("result_xdr") or a.get("status")
                                    != "ERROR"))]
        if unreasoned:
            raise AssertionError(f"node: /tx answers that are neither "
                                 f"accepted nor a reasoned rejection: "
                                 f"{unreasoned[:3]} ({statuses})")
        accepted = {f.content_hash() for f, a in zip(frames, answers)
                    if a["status"] == "PENDING"}
        out["accepted"] = len(accepted)
        _wait("node: every accepted payment applied",
              lambda: accepted <= rec.applied().keys()
              and pipe.depth == 0, timeout, stop)
        applied = rec.applied()
        last = max(applied[h] for h in accepted) if accepted \
            else rec.closes[-1]["seq"]
        out["burst_s"] = time.perf_counter() - t3
        out["burst_ledgers"] = [c["seq"] for c in rec.closes[first:]
                                if c["seq"] <= last]
        out["launches"] = {k: fn.launches
                           for k, fn in KERNEL_WRAPPERS.items()}
        published = app.history.published_checkpoints
        _wait("node: checkpoints published",
              lambda: len(published) >= NODE_CHECKPOINTS
              and published[-1] >= last, timeout, stop, every=0.05)
        out["checkpoints"] = list(published)
        out["lcl"] = app.lm.last_closed_ledger_seq
        out["run_s"] = time.perf_counter() - t0
    except BaseException as e:  # corelint: disable=exception-hygiene -- every failure goes to node_run, which re-raises it on the main thread
        out["error"] = e
    finally:
        if up and not stop.is_set():
            os.kill(os.getpid(), signal.SIGTERM)


def node_run(device=None, n_accounts=NODE_ACCOUNTS, burst=NODE_BURST,
             tx_set=NODE_TX_SET, batch_size=NODE_BATCH,
             max_backlog=NODE_BACKLOG, chunk=NODE_CHUNK, accel_min_sigs=None,
             timeout=NODE_TIMEOUT_S, workdir=None) -> dict:
    """A node served by ``python -m stellar_core_tpu_torch run --conf``
    (main/commandline.main on this, the main, thread: `run` installs its
    signal handlers, which work only there), ACCEL "cuda" (`device` None)
    or "cpu", its clients on a helper thread (_node_client).  After
    keys.clear_verify_cache() and reset_registry(); the signal handlers
    and the checkpoint cadence are restored after it.  Then the archive
    the node published is replayed by CatchupManager with accel off (the
    verify cache cleared first)."""
    from stellar_core_tpu_torch.history.archive import (
        FileHistoryArchive, checkpoint_frequency, set_checkpoint_frequency)
    from stellar_core_tpu_torch.main import commandline
    if threading.current_thread() is not threading.main_thread():
        raise RuntimeError("node_run serves the node on the main thread")
    crypto_keys.clear_verify_cache()
    metrics.reset_registry()
    cadence = checkpoint_frequency()
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                  signal.SIGTERM)}
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="chip-smoke-node-")
    archive = os.path.join(workdir, "archive")
    port = _free_port()
    conf = node_config(os.path.join(workdir, "node.toml"), archive, port,
                       "cuda" if device is None else str(device),
                       batch_size, max_backlog, chunk)
    out, stop = {}, threading.Event()
    try:
        with _HostCrypto() as host, \
                _NodeRecorder(accel_min_sigs) as rec:
            client = threading.Thread(
                target=_node_client, name="chip-smoke-node-client",
                args=(port, rec, out, stop, n_accounts, burst, tx_set,
                      timeout), daemon=True)
            client.start()
            t0 = time.perf_counter()
            # a node that never stops fails the phase with every thread's
            # stack instead of holding the card until the script's limit
            faulthandler.dump_traceback_later(timeout + 120.0, exit=True)
            try:
                rc = commandline.main(["run", "--conf", conf])
            finally:
                stop.set()
                client.join(timeout + 60.0)
                faulthandler.cancel_dump_traceback_later()
            serve_s = time.perf_counter() - t0
            host_all = host.snapshot()
        if rc != 0:
            raise AssertionError(f"node: run exited {rc}")
        if "error" in out:
            raise out["error"]
        if rec.app is None or client.is_alive():
            raise AssertionError(f"node: the node never served its clients "
                                 f"({out})")
        pipe = rec.app.herder.admission
        # the oracle: the published archive replayed on the CPU
        crypto_keys.clear_verify_cache()
        t1 = time.perf_counter()
        cm = CatchupManager(rec.app.network_id, NODE_PASSPHRASE, accel=False)
        replayed = cm.catchup_complete(FileHistoryArchive(archive))
        replay_s = time.perf_counter() - t1
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
        set_checkpoint_frequency(cadence)
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
    node_hash = {c["seq"]: c["hash"] for c in rec.closes}
    return {**out, "serve_s": serve_s, "replay_s": replay_s,
            "replayed": (replayed.last_closed_ledger_seq,
                         replayed.lcl_hash.hex()),
            "node_hash": node_hash, "closes": rec.closes, "pipe": pipe,
            "log": rec.log, "stats": _stats(pipe), "host": host_all,
            "port": port}


def node_phase(device=None, **kw) -> dict:
    """The node phase: node_run on `device` (None: the card), held to its
    limits: every /tx answer accepted or a reasoned rejection (checked as
    the clients read them), every accepted payment applied, the archive's
    CPU replay on the node's hash of its last checkpoint, and
    check_card_use's limits."""
    run = node_run(device, **kw)
    seq, replay_hash = run["replayed"]
    if seq not in run["checkpoints"] or run["node_hash"].get(seq) \
            != replay_hash:
        raise AssertionError(f"node: the CPU replay of its archive ends at "
                             f"{seq} on {replay_hash}, the node closed "
                             f"{run['node_hash'].get(seq)} there "
                             f"(checkpoints {run['checkpoints']})")
    if run["stats"].get("admitted", 0) < run["accepted"]:
        raise AssertionError(f"node: {run['accepted']} accepted, "
                             f"{run['stats']} admitted")
    checks = check_card_use("node", run["pipe"], run["log"], run["launches"])
    n_ledgers = len(run["burst_ledgers"])
    return {"phase": "node", "signer": signer_name(),
            "x25519": x25519_path(), "statuses": run["statuses"],
            "accepted": run["accepted"], "applied": run["accepted"],
            "accounts_s": run["accounts_s"],
            "accounts_ledger": run["accounts_ledger"],
            "warm_s": run["warm_s"], "client_sign_s": run["client_sign_s"],
            "post_s": run["post_s"],
            "admitted_tx_per_s": run["accepted"] / run["post_s"],
            "burst_s": run["burst_s"], "burst_ledgers": n_ledgers,
            "ledgers_per_s": n_ledgers / run["burst_s"],
            "checkpoints": run["checkpoints"], "lcl": run["lcl"],
            "replayed_to": seq, "replay_hash": replay_hash,
            "last_closed": (run["closes"][-1]["seq"],
                            run["closes"][-1]["hash"]),
            "replay_s": run["replay_s"], "serve_s": run["serve_s"],
            "stats": run["stats"], "launches": run["launches"],
            "collect_wait_s": run["stats"].get("collect_wait_s", 0.0),
            "host": run["host"], "batch_checks": checks}


def network_run(accel: bool, device=None, n_accounts=NETWORK_ACCOUNTS,
                n_ledgers=NETWORK_LEDGERS, burst=NETWORK_BURST,
                tx_set=NETWORK_TX_SET, batch_size=NETWORK_BATCH,
                max_backlog=NETWORK_BACKLOG, **knobs) -> dict:
    """NETWORK_VALIDATORS validators of simulation.Simulation on its
    VIRTUAL_TIME clock, a NETWORK_THRESHOLD-of-n quorum set, each with
    `n_accounts` seed-derived accounts (LoadGenerator.install_account_pool,
    the same on each) and the ledger's maxTxSetSize `tx_set`, admission on
    each (SimNode.enable_admission: accel on `device` where `accel`),
    peers on loopback, authenticated.  With accel, each pipeline's warm
    batch is waited for; launch counts are set to 0 before the burst:
    `burst` payments submitted at the first node, every pipeline drained
    while the overlay floods them, then every validator bootstrapped and
    the clock cranked until each closed `n_ledgers` ledgers.  Returns each
    node's closes (_close_record), the statuses, the admission stats and
    batch logs of every node, the host's Ed25519 calls and the times."""
    from stellar_core_tpu_torch.simulation.loadgen import (LoadGenerator,
                                                           SeedAccountPool)
    from stellar_core_tpu_torch.simulation.simulation import (Simulation,
                                                              qset_of)
    crypto_keys.clear_verify_cache()
    metrics.reset_registry()
    with _HostCrypto() as host:
        t0 = time.perf_counter()
        sim = Simulation(NETWORK_PASSPHRASE.encode(), accel=accel,
                         accel_device=device)
        secrets = [SecretKey(sha256(b"chip smoke network validator %d" % i))
                   for i in range(NETWORK_VALIDATORS)]
        qset = qset_of([s.public_key.ed25519 for s in secrets],
                       NETWORK_THRESHOLD)
        pool = SeedAccountPool(n_accounts, seed=CONSENSUS_SEED)
        closes = {}
        for s in secrets:
            lm = LedgerManager(sim.network_id, invariant_manager=None)
            lm.start_new_ledger()
            lm.lcl_header.maxTxSetSize = tx_set
            LoadGenerator(lm, seed=CONSENSUS_SEED, clock=sim.clock) \
                .install_account_pool(pool)
            node = sim.add_node(s, qset, ledger_manager=lm)
            node.enable_admission(batch_size=batch_size,
                                  max_backlog=max_backlog, **knobs)
            hook = node.herder.ledger_closed_hook
            mine = closes[node.node_id] = []

            def closed(arts, hook=hook, mine=mine):
                hook(arts)
                mine.append(_close_record(arts))

            node.herder.ledger_closed_hook = closed
        pipes = [n.herder.admission for n in sim.nodes]
        logs = [_BatchLog(p) for p in pipes]
        try:
            for i, a in enumerate(sim.nodes):
                for b in sim.nodes[i + 1:]:
                    sim.connect(a, b)
            sim.crank_for_at_least(0.1)
            peers = [n.overlay.num_authenticated() for n in sim.nodes]
            if peers != [NETWORK_VALIDATORS - 1] * NETWORK_VALIDATORS:
                raise AssertionError(f"network: handshakes did not all "
                                     f"authenticate: {peers}")
            setup_s = time.perf_counter() - t0
            warm_s = [wait_warm(p) for p in pipes] if accel else None
            start = sim.nodes[0].lcl
            for fn in KERNEL_WRAPPERS.values():
                fn.launches = 0
            before = host.snapshot()
            rng = random.Random(CONSENSUS_SEED + 2)
            t1 = time.perf_counter()
            frames = [build_tx(sim.network_id, pool.secret(i),
                               pool.next_seq(i),
                               [native_payment_op(pool.account_id(
                                   rng.randrange(n_accounts)), 100)],
                               fee=100 + rng.randrange(200))
                      for i in rng.sample(range(n_accounts), burst)]
            t2 = time.perf_counter()
            statuses = {}
            for f in frames:
                code = sim.nodes[0].submit(f).code
                statuses[code] = statuses.get(code, 0) + 1
            for _ in range(3):          # floods reach the peers, who admit
                for p in pipes:
                    p.drain()
                sim.crank_for_at_least(1.0)
            admit_s = time.perf_counter() - t2
            t3 = time.perf_counter()
            for n in sim.nodes:
                n.herder.bootstrap()
            if not sim.crank_until_ledger(start + n_ledgers,
                                          timeout=60.0 * n_ledgers):
                raise AssertionError(f"network: ledgers stalled at "
                                     f"{[n.lcl for n in sim.nodes]}")
            run_s = time.perf_counter() - t3
            launches = {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}
            after = host.snapshot()
        finally:
            for p in pipes:
                p.close()
    by_node = [closes[n.node_id] for n in sim.nodes]
    return {"closes": by_node, "statuses": statuses, "start": start,
            "queued_after": [n.herder.tx_queue.size for n in sim.nodes],
            "stats": [_stats(p) for p in pipes], "pipes": pipes,
            "logs": logs, "launches": launches, "setup_s": setup_s,
            "warm_s": warm_s, "client_sign_s": t2 - t1, "admit_s": admit_s,
            "run_s": run_s, "admitted": pipes[0].stats["admitted"],
            "host": {k: after[k] - before[k] for k in after}}


def _network_view(run: dict, node: int = 0) -> list:
    """What of a network_run two runs of one script must share: a
    validator's ledgers (the first's; the others' are held equal to it
    apart)."""
    return [{k: v for k, v in c.items() if k != "succeeded"}
            for c in run["closes"][node]]


def network_phase(device=None, **kw) -> dict:
    """The network phase: network_run with accel on `device` (None: the
    card) against the same script with accel off.  Every validator closes
    every ledger on the same hash, tx-set hash and result set; those of
    the card's run are the oracle's, every admitted transaction is
    applied on every node, and each pipeline keeps check_card_use's
    limits."""
    oracle = network_run(False, **kw)
    card = network_run(True, device, **kw)
    for name, run in (("card", card), ("oracle", oracle)):
        first = _network_view(run)
        for i in range(1, len(run["closes"])):
            view = _network_view(run, i)
            n = min(len(view), len(first))
            if view[:n] != first[:n]:
                raise AssertionError(f"network ({name}): validator {i} "
                                     f"closed differently from validator "
                                     f"0: {view} != {first}")
    if (_network_view(card), card["statuses"]) \
            != (_network_view(oracle), oracle["statuses"]):
        raise AssertionError(f"network: the card's ledgers differ from the "
                             f"accel-off oracle's: {_network_view(card)} "
                             f"{card['statuses']} != {_network_view(oracle)} "
                             f"{oracle['statuses']}")
    applied = sum(c["applied"] for c in card["closes"][0])
    if any(card["queued_after"]) or applied != card["admitted"]:
        raise AssertionError(f"network: admitted transactions left "
                             f"unapplied: {applied} applied of "
                             f"{card['admitted']}, queues "
                             f"{card['queued_after']}")
    checks = [check_card_use(f"network, validator {i}", p, log,
                             card["launches"])
              for i, (p, log) in enumerate(zip(card["pipes"],
                                               card["logs"]))]
    n = len(card["closes"][0])
    return {"phase": "network", "signer": signer_name(),
            "x25519": x25519_path(), "validators": NETWORK_VALIDATORS,
            "threshold": NETWORK_THRESHOLD, "ledgers": n,
            "last_hash": card["closes"][0][-1]["hash"],
            "applied": applied, "equals_oracle": True,
            "statuses": card["statuses"], "setup_s": card["setup_s"],
            "warm_s": card["warm_s"], "client_sign_s": card["client_sign_s"],
            "admit_s": card["admit_s"],
            "admitted_tx_per_s": card["admitted"] / card["admit_s"],
            "run_s": card["run_s"], "ledgers_per_s": n / card["run_s"],
            "oracle_admit_s": oracle["admit_s"],
            "oracle_run_s": oracle["run_s"], "stats": card["stats"],
            "launches": card["launches"],
            "collect_wait_s": sum(s.get("collect_wait_s", 0.0)
                                  for s in card["stats"]),
            "host": card["host"], "oracle_host": oracle["host"],
            "batch_checks": checks, "oracle_view": _network_view(oracle)}


# -- the fleet: five `run` processes over TCP, a rejoin by parallel catchup ---

# the reference's acceptance fleet (tests/test_fleet.py:210-221): the
# `fleet` command's defaults (five validators, a simple majority, a
# checkpoint every 8 ledgers, one shared file archive; the standard
# schedule at 25 tx/s over 60 accounts, native-close differential 8), held
# to the acceptance test's SLOs, which are tighter than the command's
FLEET_NODES = 5
FLEET_PASSPHRASE = "fleet soak net"      # simulation.fleet.Fleet's default
FLEET_CHECKPOINT_FREQUENCY = 8
FLEET_KILLED = 2                         # standard_schedule's kill node
FLEET_SLOS = {"max_p99_close_s": 2.0, "max_shed_rate": 0.35,
              "max_retracking_s": 90.0, "max_roll_node_s": 60.0}
FLEET_TIMEOUT_S = 900.0
# a range's line in the rejoin's catchup.log (catchup.parallel.range_summary,
# printed by `catchup --parallel`) and the command's last line
RANGE_LINE = re.compile(
    r"^range (\d+): (\d+) ledgers to (\d+) \(([\d.]+) ledgers/s\), offload "
    r"hit rate ([\d.]+), launches (\{.*\}|none)$", re.M)
CAUGHT_UP = re.compile(r"^caught up to ledger (\d+) hash ([0-9a-f]{64}) "
                       r"\((\d+) ranges, (\d+) stitches verified", re.M)


def _repo_env(**kw) -> dict:
    """This process's environment with the repo on PYTHONPATH and STPU_ACCEL
    left out, updated with `kw`."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "STPU_ACCEL"}
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env.update(kw)
    return env


def smi_compute_apps() -> dict:
    """{pid: MiB} of the processes holding a CUDA context, as nvidia-smi
    --query-compute-apps gives them; {} where it does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    apps = {}
    for line in out.stdout.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit():
            apps[int(parts[0])] = int(parts[1])
    return apps


def fleet_run(workdir: str) -> dict:
    """`python -m stellar_core_tpu_torch fleet --nodes 5 --workdir
    <workdir>` as a subprocess, on the command's defaults and with
    STPU_ACCEL unset, so every node and range worker takes ACCEL "cuda".
    While it runs, nvidia-smi's compute apps are sampled every 2 s (the
    most card memory each process held, where it answers).  Then the
    fleet's archive is replayed on the CPU by `catchup --accel none`.
    Returns the exit code, the seconds and the CPU seconds of all its
    processes, the kernel libraries built while it ran, the report, the
    rejoin's catchup.log, the merged trace's events, the samples, each
    node's stored hash of the archive's tip ledger and the replay's
    (ledger, hash)."""
    env = _repo_env()
    peak, stop = {}, threading.Event()

    def sample():
        while not stop.wait(2.0):
            for pid, mib in smi_compute_apps().items():
                peak[pid] = max(peak.get(pid, 0), mib)

    sampler = threading.Thread(target=sample, name="chip-smoke-smi",
                               daemon=True)
    sampler.start()
    import resource
    libs = set(_cuda_build.BUILD_DIR.glob("*.so"))
    cpu0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.perf_counter()
    # its own process group: a fleet past its limit is killed with every
    # node and worker it started
    proc = subprocess.Popen(
        [sys.executable, "-m", "stellar_core_tpu_torch", "fleet",
         "--nodes", str(FLEET_NODES), "--workdir", workdir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        start_new_session=True)
    try:
        _out, err = proc.communicate(timeout=FLEET_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"fleet: not done within {FLEET_TIMEOUT_S} s")
    finally:
        stop.set()
        sampler.join(30.0)
    seconds = time.perf_counter() - t0
    # the fleet's processes, each reaped by its parent: the command, its
    # nodes and the rejoin's orchestrator and range workers
    cpu1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    cpu_s = (cpu1.ru_utime - cpu0.ru_utime) + (cpu1.ru_stime - cpu0.ru_stime)
    built = sorted(p.name for p in
                   set(_cuda_build.BUILD_DIR.glob("*.so")) - libs)

    def read(*path):
        path = os.path.join(workdir, *path)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.read()

    report = read("fleet-report.json")
    report = json.loads(report) if report else None
    trace = read("fleet-trace.json")
    run = {"rc": proc.returncode, "seconds": seconds, "report": report,
           "cpu_s": cpu_s, "kernels_built": built,
           "stderr_tail": err[-3000:],
           "catchup_log": read(f"node-{FLEET_KILLED}", "catchup.log") or "",
           "trace_events": json.loads(trace)["traceEvents"] if trace else [],
           "smi_peak_mib": peak}
    if report is None:
        return run
    # each node's durable header of the archive's tip ledger: the hash it
    # closed there, where the fleet's /info samples skipped that ledger
    from stellar_core_tpu_torch.database import Database
    tip, run["stored_tip_hashes"] = report["archive_tip"], {}
    for art in report["node_artifacts"]:
        path = os.path.join(workdir, f"node-{art['index']}", "node.db")
        if tip is None or not os.path.exists(path):
            continue
        db = Database(path)
        try:
            row = db.load_header_by_seq(tip)
        finally:
            db.close()
        if row is not None:
            run["stored_tip_hashes"][str(art["index"])] = row[0].hex()
    conf = os.path.join(workdir, "replay.cfg")
    with open(conf, "w") as f:
        f.write(f'NETWORK_PASSPHRASE = "{FLEET_PASSPHRASE}"\n'
                f"CHECKPOINT_FREQUENCY = {FLEET_CHECKPOINT_FREQUENCY}\n")
    t1 = time.perf_counter()
    replay = subprocess.run(
        [sys.executable, "-m", "stellar_core_tpu_torch", "catchup", "--conf",
         conf, "--archive", os.path.join(workdir, "archive"), "--accel",
         "none"], capture_output=True, text=True, env=_repo_env(),
        timeout=600)
    run["replay_s"] = time.perf_counter() - t1
    got = re.search(r"caught up to ledger (\d+) hash ([0-9a-f]{64})",
                    replay.stdout)
    run["replay"] = (int(got.group(1)), got.group(2)) if got \
        and replay.returncode == 0 else (None, replay.stderr[-2000:])
    return run


def fleet_ranges(catchup_log: str) -> list:
    """The rejoin's ranges, as its catchup.log's range lines give them."""
    return [{"index": int(m[0]), "ledgers": int(m[1]), "to": int(m[2]),
             "ledgers_per_s": float(m[3]), "hit_rate": float(m[4]),
             "launches": None if m[5] == "none" else json.loads(m[5])}
            for m in RANGE_LINE.findall(catchup_log)]


def fleet_processes(report: dict) -> list:
    """Every node process the fleet scraped: its node, pid, device, K-G
    launches and admission batches on the card and on the CPU (the warm
    batch is a dispatched group of its own, not an admission batch)."""
    out = []
    for art in report["node_artifacts"]:
        for rec in art.get("accel") or [{}]:
            adm = rec.get("admission") or {}
            card = max(0, adm.get("dispatch_groups", 0) - 1)
            out.append({
                "node": art["index"], "pid": rec.get("pid"),
                "accel": rec.get("accel"), "devices": rec.get("devices"),
                "cuda_initialized": rec.get("cuda_initialized"),
                "K-G": (rec.get("launches") or {}).get("K-G", 0),
                "warm_dispatched": adm.get("dispatch_groups", 0) >= 1,
                "warmed": adm.get("warmed"),
                "batches_card": card,
                "batches_cpu": adm.get("batches", 0) - card,
                "sigs_offloaded": adm.get("sigs_offloaded", 0)})
    return out


def fleet_checks(run: dict) -> dict:
    """Hold a fleet run to its limits; raises AssertionError naming every
    one it missed.  The command exited 0 (every SLO of its FleetSLOs held,
    and its divergence check: no two nodes reported different hashes for
    a ledger); the acceptance test's tighter SLOs and checks
    (tests/test_fleet.py:221-269) hold on its report; the CPU replay of
    the archive ends on its tip, on the hash a majority of the nodes
    stored there, and no node stored another.  No process built a kernel
    library (chip_smoke.py builds them first).  Every node process opened
    the card and launched K-G (its warm batch), and every range of the
    rejoin launched K-G and shipped verdicts from the card.  Returns what
    it read."""
    report, bad = run["report"], []
    if report is None:
        raise AssertionError(f"fleet: no report (exit {run['rc']}): "
                             f"{run['stderr_tail']}")
    if run["rc"] != 0 or not report["passed"]:
        bad.append(f"exit {run['rc']}, violations {report['violations']}")
    metrics_ = report["metrics"]
    traffic = report["traffic"]
    p99 = report.get("p99_close_s")
    if p99 is not None and p99 > FLEET_SLOS["max_p99_close_s"]:
        bad.append(f"close p99 {p99} s")
    if traffic["shed_rate"] > FLEET_SLOS["max_shed_rate"]:
        bad.append(f"shed rate {traffic['shed_rate']}")
    retr = metrics_.get("retracking_s")
    if retr is None or retr > FLEET_SLOS["max_retracking_s"]:
        bad.append(f"retracking {retr} s")
    rolls = metrics_.get("roll_node_s", {})
    if len(rolls) != FLEET_NODES or any(
            v > FLEET_SLOS["max_roll_node_s"] for v in rolls.values()):
        bad.append(f"rolls {rolls}")
    if traffic["statuses"].get("PENDING", 0) <= 50:
        bad.append(f"PENDING answers {traffic['statuses']}")
    if report["divergence_seqs_compared"] < 5:
        bad.append(f"{report['divergence_seqs_compared']} ledgers compared")
    if report["archive_tip"] is None or report["archive_tip"] < 15:
        bad.append(f"archive tip {report['archive_tip']}")
    log = run["catchup_log"]
    if "ranges" not in log or "stitches verified" not in log:
        bad.append(f"catchup.log shows no ranges and stitches: {log[-500:]}")
    events = run["trace_events"]
    obs = report["observability"]
    rows = {e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    phases = {e["name"].split("@")[0] for e in events if e.get("ph") == "i"}
    scr = obs.get("scraper") or {}
    if not {f"node-{n}" for n in range(FLEET_NODES)} <= rows \
            or obs["trace_events"] != len(events) \
            or not {"close-seal", "externalize"} <= phases \
            or len(obs["trace_nodes"]) != FLEET_NODES \
            or set(obs["clock_offsets_s"]) != set(obs["trace_nodes"]):
        bad.append(f"merged trace: rows {sorted(rows)}, phases "
                   f"{sorted(phases)}, nodes {obs['trace_nodes']}")
    curves = (scr.get("curves") or {}).get("close_p99_s") or {}
    if not scr.get("polls") or not any(len(c) >= 2 for c in curves.values()) \
            or (scr.get("divergence") or {}).get("close_p99_s") is None \
            or not scr["slo"]["objectives"]["close-p99"]["evaluations"]:
        bad.append("the scraper's SLO curves or burn tracker are empty")
    # the tip ledger's hash as each node stored it
    tip, by_node = report["archive_tip"], run.get("stored_tip_hashes", {})
    reported = set(by_node.values())
    if run.get("replay") is None or run["replay"][0] != tip \
            or reported != {run["replay"][1]} \
            or len(by_node) < FLEET_NODES // 2 + 1:
        bad.append(f"the CPU replay ended on {run.get('replay')}, the nodes "
                   f"stored {by_node} for the archive's tip {tip}")
    if run.get("kernels_built"):
        bad.append(f"fleet processes built kernels: {run['kernels_built']}")
    procs = fleet_processes(report)
    ranges = fleet_ranges(log)
    caught = CAUGHT_UP.search(log)
    if not ranges or caught is None or int(caught.group(3)) != len(ranges):
        bad.append(f"the rejoin's ranges are not in its log: {log[-500:]}")
    for p in procs:
        if p["accel"] != "cuda" or not p["devices"] \
                or not all(d.startswith("cuda") for d in p["devices"]) \
                or not p["cuda_initialized"] or p["K-G"] < 1 \
                or not p["warm_dispatched"]:
            bad.append(f"node {p['node']} process {p['pid']} did not "
                       f"verify its warm batch on the card: {p}")
    for r in ranges:
        if not r["launches"] or r["launches"].get("K-G", 0) < 1 \
                or r["hit_rate"] <= 0:
            bad.append(f"rejoin range {r['index']} did not verify on "
                       f"the card: {r}")
    if bad:
        raise AssertionError("fleet: " + "; ".join(bad))
    return {"processes": procs, "ranges": ranges}


def fleet_phase() -> dict:
    """The fleet phase: fleet_run on the card in a temporary directory,
    held to fleet_checks."""
    workdir = tempfile.mkdtemp(prefix="chip-smoke-fleet-")
    try:
        run = fleet_run(workdir)
        try:
            seen = fleet_checks(run)
        except AssertionError as e:
            # what the run gave, for the failure's post-mortem
            report = run["report"] or {}
            emit({"phase": "fleet", "failed": str(e)[:4000],
                  "seconds": run["seconds"], "rc": run["rc"],
                  **{k: report.get(k) for k in (
                      "violations", "wall_s", "max_ledger", "p99_close_s",
                      "traffic", "metrics", "archive_tip")},
                  "events": report.get("events", [])[-12:],
                  "ranges": fleet_ranges(run["catchup_log"]),
                  "stored_tip_hashes": run.get("stored_tip_hashes"),
                  "replay": run.get("replay")})
            raise
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    report = run["report"]
    wall = report["wall_s"]
    procs = seen["processes"]
    per_node = {}
    for p in procs:
        row = per_node.setdefault(p["node"], {"processes": 0, "K-G": 0,
                                              "batches_card": 0,
                                              "batches_cpu": 0})
        row["processes"] += 1
        for k in ("K-G", "batches_card", "batches_cpu"):
            row[k] += p[k]
    smi = run["smi_peak_mib"]
    at = {e["event"].split(" (")[0]: e["t_s"] for e in report["events"]}
    return {"phase": "fleet", "signer": signer_name(),
            "x25519": x25519_path(), "nodes": FLEET_NODES,
            "seconds": run["seconds"], "wall_s": wall,
            "boot_s": (at["all nodes healthy"]
                       - at.get(f"launched {FLEET_NODES} run processes", 0.0)
                       if "all nodes healthy" in at else None),
            "cpu_s": run["cpu_s"], "cpu_cores_busy": run["cpu_s"] / wall,
            "kernels_built": run["kernels_built"],
            "max_ledger": report["max_ledger"],
            "ledgers_per_s": report["max_ledger"] / wall,
            "archive_tip": report["archive_tip"],
            "p99_close_s": report["p99_close_s"],
            "traffic": report["traffic"],
            "pending": report["traffic"]["statuses"].get("PENDING", 0),
            "shed": report["traffic"]["statuses"].get("TRY-AGAIN-LATER", 0),
            "retracking_s": report["metrics"]["retracking_s"],
            "kill_to_retracking_s":
                report["metrics"]["kill_to_retracking_s"],
            "roll_node_s": report["metrics"]["roll_node_s"],
            "native": {k: v for k, v in report["metrics"].items()
                       if k.startswith("native_")},
            "divergence_seqs_compared": report["divergence_seqs_compared"],
            "per_node": per_node, "processes": procs,
            "launches_nodes": sum(p["K-G"] for p in procs),
            "rejoin_ranges": seen["ranges"],
            "launches_rejoin": sum((r["launches"] or {}).get("K-G", 0)
                                   for r in seen["ranges"]),
            "replay": run["replay"], "replay_s": run["replay_s"],
            "smi_compute_apps_mib": {
                str(p["pid"]): smi.get(p["pid"]) for p in procs} if smi
            else "nvidia-smi --query-compute-apps gave no process",
            "smi_compute_apps_all_mib": smi}


# -- the commands: the port's CLI over the node phase's state ---------------

def _cli(argv) -> tuple:
    """stellar_core_tpu_torch's command line in this process: (exit code,
    standard output, seconds).  The checkpoint cadence the command's config
    sets is restored after it."""
    import contextlib
    import io
    from stellar_core_tpu_torch.history.archive import (
        checkpoint_frequency, set_checkpoint_frequency)
    from stellar_core_tpu_torch.main import commandline
    cadence = checkpoint_frequency()
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = commandline.main(list(argv))
    finally:
        set_checkpoint_frequency(cadence)
    return rc, out.getvalue(), time.perf_counter() - t0


def commands_phase(node_dir: str, node: dict, device=None) -> dict:
    """The commands phase: the port's command line, in this process, over
    the state the node phase left in `node_dir` (its DATABASE, buckets and
    archive) after that node stopped, with its config's ACCEL ("cuda" on the
    card).  self-check must report ok; offline-info and diag-bucket-stats
    must name the node's last ledger (and offline-info its hash);
    dump-ledger --limit 10 must print 10 entries; verify-checkpoints on the
    node's archive must end on the hash the node phase's CPU replay reached
    and report-last-history-checkpoint print that archive's HAS; then
    publish, and new-hist into a second archive, whose HAS must be at the
    node's last ledger.  Every command must exit 0."""
    conf = os.path.join(node_dir, "node.toml")
    archive = os.path.join(node_dir, "archive")
    last_seq, last_hash = node["last_closed"]
    replay_seq, replay_hash = node["replayed_to"], node["replay_hash"]
    runs, bad = {}, []

    def run(name, *argv):
        """The command's standard output, or None after noting its exit
        code where it is not 0."""
        rc, out, secs = _cli(argv)
        runs[name] = {"rc": rc, "seconds": secs}
        if rc != 0:
            bad.append(f"{name} exited {rc}: {out[-500:]}")
            return None
        return out

    out = run("self-check", "self-check", "--conf", conf)
    if out is not None and not json.loads(out).get("ok"):
        bad.append(f"self-check: {out[-500:]}")
    out = run("offline-info", "offline-info", "--conf", conf)
    if out is not None:
        ledger = json.loads(out)["info"]["ledger"]
        if (ledger["num"], ledger["hash"]) != (last_seq, last_hash):
            bad.append(f"offline-info names ledger {ledger}, the node "
                       f"closed {last_seq} {last_hash} last")
    out = run("diag-bucket-stats", "diag-bucket-stats", "--conf", conf)
    if out is not None:
        stats = json.loads(out)
        runs["diag-bucket-stats"]["entries"] = stats["totals"]["entries"]
        if stats["ledger"] != last_seq:
            bad.append(f"diag-bucket-stats names ledger {stats['ledger']}")
    out = run("dump-ledger", "dump-ledger", "--conf", conf, "--limit", "10")
    entries = [json.loads(line) for line in (out or "").splitlines() if line]
    if out is not None and len(entries) != 10:
        bad.append(f"dump-ledger printed {len(entries)} entries")
    out = run("verify-checkpoints", "verify-checkpoints", "--archive",
              archive, "--conf", conf)
    got = re.search(r"through checkpoint (\d+); tip hash ([0-9a-f]{64})",
                    out or "")
    if out is not None and (got is None or (int(got.group(1)), got.group(2))
                            != (replay_seq, replay_hash)):
        bad.append(f"verify-checkpoints: {out.strip()[-300:]}, the CPU "
                   f"replay reached {replay_seq} {replay_hash}")
    out = run("report-last-history-checkpoint",
              "report-last-history-checkpoint", "--archive", archive)
    if out is not None and json.loads(out)["currentLedger"] != replay_seq:
        bad.append(f"report-last-history-checkpoint: {out[-300:]}")
    out = run("publish", "publish", "--conf", conf)
    runs["publish"]["said"] = (out or "").strip()
    # new-hist initializes the archives of its config: a second one here,
    # so that the node's archive keeps what it published
    second = os.path.join(node_dir, "archive-new-hist")
    conf2 = os.path.join(node_dir, "node-new-hist.toml")
    with open(conf) as f:
        text = f.read()
    with open(conf2, "w") as f:
        f.write(text.replace(f'"{archive}"', f'"{second}"'))
    if run("new-hist", "new-hist", "--conf", conf2) is not None:
        out = run("report-new-hist", "report-last-history-checkpoint",
                  "--archive", second)
        if out is not None and json.loads(out)["currentLedger"] != last_seq:
            bad.append(f"new-hist's HAS: {out[-300:]}")
    if bad:
        raise AssertionError("commands: " + "; ".join(bad))
    return {"phase": "commands",
            "accel": "cuda" if device is None else str(device),
            "last_closed": last_seq, "replayed_to": replay_seq,
            "dump_ledger_entries": len(entries), "commands": runs,
            "seconds": sum(r["seconds"] for r in runs.values())}


# -- determinism: the port's lint, the hash-seed differential, the card's
# path under the guard --------------------------------------------------------

DET_RULES = ("iteration-order", "float-discipline", "hash-order",
             "rng-discipline")
LINT_BASELINE = "stellar_core_tpu_torch/lint/LINT_BASELINE.json"
DET_CHILD_TIMEOUT_S = 900.0
# native/capply.c declares 19 static functions with `const uint8_t *` and
# defines them with `const uint8_t name[32]`; GCC 11 and later report each
# under -Wall (-Warray-parameter), so --warn-check fails on it, for the
# reference's build as for the port's.  The source is shared and left as it
# is; every other diagnostic, and any in another source, fails the phase.
WARN_KNOWN = ("native/capply.c", "[-Werror=array-parameter=]")


def _run_cli(argv) -> dict:
    """`python argv...` from the repo root: its exit code, output and
    seconds."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, *argv], capture_output=True,
                         text=True, timeout=600, env=_repo_env(),
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    return {"rc": res.returncode, "out": res.stdout + res.stderr,
            "seconds": time.perf_counter() - t0}


def warn_check_verdict(out: str) -> dict:
    """--warn-check's output read: each source's verdict line, and whether
    every failure is WARN_KNOWN's (a failing source's diagnostics are the
    lines up to the next verdict)."""
    verdicts, errors, current = {}, [], None
    for line in out.splitlines():
        m = re.match(r"^(native/\S+\.c): (warning-clean|FAIL.*|.*skipped.*)$",
                     line)
        if m:
            current = m.group(1)
            verdicts[current] = m.group(2)
        elif line.startswith("warn-check skipped"):
            verdicts["*"] = line
        elif " error: " in line or " warning: " in line:
            errors.append((current, line))
    failing = sorted(s for s, v in verdicts.items() if v.startswith("FAIL"))
    known = bool(failing) and failing == [WARN_KNOWN[0]] and bool(errors) \
        and all(src == WARN_KNOWN[0] and line.endswith(WARN_KNOWN[1])
                for src, line in errors)
    return {"verdicts": verdicts, "failing": failing,
            "diagnostics": len(errors), "only_known_fault": known}


def determinism_static(run_cli=_run_cli) -> dict:
    """(a): the port's lint with its baseline, the four determinism rules
    alone, and the native sources' warning gate."""
    lint = run_cli(["-m", "stellar_core_tpu_torch.lint", "--baseline",
                    LINT_BASELINE])
    det = run_cli(["-m", "stellar_core_tpu_torch.lint", "--rules",
                   ",".join(DET_RULES)])
    warn = run_cli(["-m", "stellar_core_tpu_torch._native_build",
                    "--warn-check"])
    verdict = warn_check_verdict(warn["out"])
    bad = [f"{name} exited {r['rc']}: {r['out'][-800:]}"
           for name, r in (("lint", lint), ("determinism rules", det))
           if r["rc"] != 0]
    if warn["rc"] != 0 and not verdict["only_known_fault"]:
        bad.append(f"--warn-check exited {warn['rc']}: {warn['out'][-800:]}")
    if bad:
        raise AssertionError("determinism (a): " + "; ".join(bad))

    def said(r):
        summary = re.findall(r"^corelint: .*$", r["out"], re.M)
        return {"seconds": r["seconds"],
                "said": summary[-1] if summary else None}

    return {"lint": said(lint), "determinism_rules": said(det),
            "warn_check": {"rc": warn["rc"], "seconds": warn["seconds"],
                           **verdict}}


def determinism_differential(**kw) -> list:
    """(b): simulation.hashseed_diff's two campaigns, each a pair of
    processes under its two seeds (kw: run_pair's orgs, ledgers); each must
    be IDENTICAL, with the detguard armed, regions entered and no trip."""
    reps = [hashseed_diff.run_pair(c, timeout_s=DET_CHILD_TIMEOUT_S, **kw)
            for c in hashseed_diff.CAMPAIGNS]
    bad = [f"{r['campaign']}: {r['errors'] or r['divergence']}"
           for r in reps if not r["ok"]]
    if bad:
        raise AssertionError("determinism (b): " + "; ".join(bad))
    return [{k: r[k] for k in ("campaign", "seeds", "wall_s", "identical",
                               "detguard", "children")} for r in reps]


def network_child(args_json: str) -> int:
    """(c)'s child: network_run with accel on the card (or args' device) in
    this process, which the parent started with STPU_DETGUARD=1 and its
    PYTHONHASHSEED; writes validator 0's ledgers (_network_view), whether
    every validator closed them alike, the statuses, K-G's launches and the
    guard's stats to args' `out` as JSON."""
    from stellar_core_tpu_torch.util import detguard
    args = json.loads(args_json)
    run = network_run(True, args.get("device"), **args.get("kw", {}))
    first = _network_view(run)
    agree = all(_network_view(run, i)[:len(first)] == first
                for i in range(1, len(run["closes"])))
    doc = {"hashseed": os.environ.get("PYTHONHASHSEED"), "view": first,
           "validators_agree": agree,
           "statuses": {str(k): v for k, v in run["statuses"].items()},
           "launches": run["launches"], "run_s": run["run_s"],
           "admitted": run["admitted"],
           "detguard": {"armed": detguard.enabled(), **detguard.stats()}}
    with open(args["out"], "w") as f:
        json.dump(doc, f)
    return 0


def network_child_faults(docs, want: list, device=None) -> list:
    """What (c) holds each child's document (seed, doc) to: `want`'s
    ledgers, every validator alike, the guard armed with regions entered
    and no trip, and on the card (device None) K-G launched."""
    bad = []
    for seed, doc in docs:
        guard = doc["detguard"]
        if doc["view"] != want:
            bad.append(f"seed {seed}: ledgers {doc['view']} are not the "
                       f"accel-off run's {want}")
        if not doc["validators_agree"]:
            bad.append(f"seed {seed}: the validators closed differently")
        if not (guard["armed"] and guard["regions"] > 0
                and guard["trips"] == 0):
            bad.append(f"seed {seed}: detguard {guard}")
        if device is None and not doc["launches"].get("K-G"):
            bad.append(f"seed {seed}: K-G never launched")
    return bad


def determinism_network(oracle_view: list, device=None, **kw) -> dict:
    """(c): network_child in two processes at once, one under each of
    hashseed_diff's two seeds, both armed; each must close every ledger as `oracle_view` (the accel-off
    run's ledgers, validator 0's), every validator alike, launch K-G (on
    the card) and enter guarded regions without a trip."""
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip-smoke-det-")
    procs = []
    t0 = time.perf_counter()
    try:
        for seed in hashseed_diff.DEFAULT_SEEDS:
            out = os.path.join(tmp, f"child-{seed}.json")
            arg = json.dumps({"out": out, "device": device, "kw": kw})
            env = _repo_env(PYTHONHASHSEED=str(seed), STPU_DETGUARD="1")
            with open(os.path.join(tmp, f"child-{seed}.log"), "w") as log:
                procs.append((seed, out, log.name, subprocess.Popen(
                    [sys.executable, "-c", "import sys, chip_smoke; "
                     "sys.exit(chip_smoke.network_child(sys.argv[1]))", arg],
                    cwd=repo, env=env, stdout=log,
                    stderr=subprocess.STDOUT)))
        docs, bad = [], []
        deadline = time.perf_counter() + DET_CHILD_TIMEOUT_S
        for seed, out, log, proc in procs:
            try:
                proc.wait(max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            if proc.returncode != 0:
                with open(log) as f:
                    tail = f.read()[-1500:]
                bad.append(f"seed {seed}: exit {proc.returncode}: {tail}")
                continue
            with open(out) as f:
                docs.append((seed, json.load(f)))
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    want = json.loads(json.dumps(oracle_view))
    bad += network_child_faults(docs, want, device)
    if bad:
        raise AssertionError("determinism (c): " + "; ".join(bad))
    return {"seeds": list(hashseed_diff.DEFAULT_SEEDS), "wall_s": wall_s,
            "ledgers": len(want), "last_hash": want[-1]["hash"],
            "children": [{k: d[k] for k in ("hashseed", "launches", "run_s",
                                            "admitted", "statuses",
                                            "detguard")} for _, d in docs]}


def determinism_phase(oracle_view: list, device=None, differential=None,
                      network=None, run_cli=_run_cli) -> dict:
    """The determinism phase: (a) determinism_static, then (b)
    determinism_differential (kw `differential`) on a helper thread beside
    (c) determinism_network (kw `network`), against the network phase's
    accel-off ledgers `oracle_view`.  Any part's failure fails the phase."""
    t0 = time.perf_counter()
    static = determinism_static(run_cli)
    static_s = time.perf_counter() - t0
    got = {}

    def differential_part():
        t1 = time.perf_counter()
        try:
            got["campaigns"] = determinism_differential(**(differential or {}))
        except BaseException as e:  # corelint: disable=exception-hygiene -- handed to the main thread, which re-raises it below
            got["error"] = e
        got["seconds"] = time.perf_counter() - t1

    helper = threading.Thread(target=differential_part,
                              name="chip-smoke-differential", daemon=True)
    helper.start()
    try:
        t2 = time.perf_counter()
        card = determinism_network(oracle_view, device, **(network or {}))
        card_s = time.perf_counter() - t2
    finally:
        helper.join()
    if "error" in got:
        raise got["error"]
    return {"phase": "determinism", "static": static, "static_s": static_s,
            "differential": got["campaigns"],
            "differential_s": got["seconds"], "network": card,
            "network_s": card_s}


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
    if run["launches"]["K-W"] != 4 or run["launches"]["K-QF"] < 1 \
            or run["launches"]["K-G"] < 1:
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


def admission_launches(admitted: dict, consensus: dict, node: dict,
                       network: dict, fleet: dict) -> dict:
    """K-G's launches on each path of the live node (the kernels line's
    admission_launches): the admission phase's two runs, the standalone
    validator, the node served by `run`, the three validators, the
    fleet's node processes (their warm batches and admission) and its
    rejoin's range workers."""
    return {"admission_a": admitted["a"]["launches"]["K-G"],
            "admission_b": admitted["b"]["launches"]["K-G"],
            "consensus": consensus["launches"]["K-G"],
            "node": node["launches"]["K-G"],
            "network": network["launches"]["K-G"],
            "fleet_nodes": fleet["launches_nodes"],
            "fleet_rejoin": fleet["launches_rejoin"]}


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
    for m in (RAGGED_N, ADMISSION_CHUNK, ADMISSION_BATCH):
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
        "ms_256": cuda_ms(
            lambda: ed25519.verify_generic(*kg_sub[ADMISSION_BATCH]), 20),
        "bound_256": bound_ms(ADMISSION_BATCH * kg_imads(),
                              ADMISSION_BATCH * (96 + 4 + 1) + keys.numel()),
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
          "K-G": {"signatures": [COLD_CHUNK, RAGGED_N, ADMISSION_CHUNK,
                                 ADMISSION_BATCH],
                  "mismatches": kg_bad, "imads_per_sig": kg_imads(),
                  "ms": timing["K-G"]["ms"],
                  "ms_2048": timing["K-G"]["ms_2048"],
                  "ms_256": timing["K-G"]["ms_256"],
                  "bound_ms": timing["K-G"]["bound"][0],
                  "bound_ms_2048": timing["K-G"]["bound_2048"][0],
                  "bound_ms_256": timing["K-G"]["bound_256"][0]},
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

    # -- ledger apply: the replay's apply half on the card's verdicts ------
    # the oracle's chain, published as it closes for the catchup phase
    archive_dir = tempfile.mkdtemp(prefix="chip-smoke-archive-")
    try:
        archive = apply_archive(archive_dir=archive_dir)
        applied = ledger_apply(archive=archive)
        applied["nvidia_smi"] = smi
        emit(applied)

        # -- catchup: the archive replayed through the port's catchup ------
        replayed = catchup_phase(archive, archive_dir)
        replayed["nvidia_smi"] = smi
        emit(replayed)
    finally:
        shutil.rmtree(archive_dir, ignore_errors=True)

    # -- admission and consensus: the live node's intake and its closes ---
    t0 = time.perf_counter()
    admitted = admission_phase()
    admitted.update(seconds=time.perf_counter() - t0, nvidia_smi=smi)
    emit(admitted)
    t0 = time.perf_counter()
    consensus = consensus_phase()
    consensus.update(seconds=time.perf_counter() - t0, nvidia_smi=smi)
    emit(consensus)

    # -- a node served by `run`, and three validators over the overlay ----
    # the node's state (database, buckets, archive) stays for the commands
    node_dir = tempfile.mkdtemp(prefix="chip-smoke-node-")
    try:
        t0 = time.perf_counter()
        node = node_phase(workdir=node_dir)
        node.update(seconds=time.perf_counter() - t0, nvidia_smi=smi)
        emit(node)
        t0 = time.perf_counter()
        network = network_phase()
        network_oracle = network.pop("oracle_view")
        network.update(seconds=time.perf_counter() - t0, nvidia_smi=smi)
        emit(network)

        # -- five `run` processes over TCP, a rejoin by parallel catchup --
        t0 = time.perf_counter()
        fleet = fleet_phase()
        fleet.update(phase_s=time.perf_counter() - t0, nvidia_smi=smi)
        emit(fleet)

        # -- the port's command line over the node phase's state ----------
        commands = commands_phase(node_dir, node)
        commands["nvidia_smi"] = smi
        emit(commands)
    finally:
        shutil.rmtree(node_dir, ignore_errors=True)

    # -- determinism: the lint, the hash-seed differential, and the
    # network's card run in two processes under two hash seeds, guarded ---
    t0 = time.perf_counter()
    det = determinism_phase(network_oracle)
    det.update(seconds=time.perf_counter() - t0, nvidia_smi=smi)
    emit(det)

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
    # K-G on admission's path: its launches in each run, its time and bound
    # at admission's batch of 256 signatures
    next(k for k in kernels if k["name"] == "K-G").update({
        "admission_launches": admission_launches(admitted, consensus, node,
                                                 network, fleet),
        "admission_ms": timing["K-G"]["ms_256"],
        "admission_bound_ms": timing["K-G"]["bound_256"][0]})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
