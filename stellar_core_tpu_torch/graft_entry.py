"""The graft entry of the port: counterpart of __graft_entry__.py.

``entry()`` gives the single-card forward step, K-W (``ed25519.
verify_windows``) on eight signatures, as ``(fn, args)``.
``dryrun_multigpu(n)`` runs the first two checks of the JAX package's
``dryrun_multichip``: the signature batch split over n shards, each verified
by K-W with its accept count fused, the counts summed on the first device
(the reference's ``psum``); then the quorum enumerator's prune step sharded
over the same devices.  Its third check, catchup over the mesh, needs the
port's catchup slice.
"""

from __future__ import annotations

import hashlib
import random

import numpy as np
import torch

from .accel import ed25519 as E
from .accel.quorum import CudaQuorumIntersectionChecker
from .crypto import sodium
from .device import Shards, on_device, parts, resolve, upload
from .testutils import nid, qset

SHARD_SIGS = 32   # signatures a shard: several warps, as the reference's 32


def _example_batch(n, seed=0):
    """(windows (127, n) int32, keys (n, 3, 32) uint8, r_bytes (n, 32)
    uint8) for n signatures of the reference's four seed keys over
    random.Random(seed) messages: the reference's _example_batch
    (__graft_entry__.py:19-47), with its key limbs as the port's key rows."""
    rng = random.Random(seed)
    keys = np.zeros((n, 3, 32), dtype=np.uint8)
    s_raw = np.zeros((n, 32), dtype=np.uint8)
    h_raw = np.zeros((n, 32), dtype=np.uint8)
    r_bytes = np.zeros((n, 32), dtype=np.uint8)
    seed_keys = [sodium.sign_seed_keypair(bytes([i]) * 32) for i in range(4)]
    for i in range(n):
        pk, sk = seed_keys[i % len(seed_keys)]
        msg = bytes(rng.randrange(256) for _ in range(64))
        sig = sodium.sign_detached(msg, sk)
        keys[i] = E.Ed25519BatchVerifier._decode_pk(pk)
        h = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(),
                           "little") % E.L
        s_raw[i] = np.frombuffer(sig[32:], dtype=np.uint8)
        h_raw[i] = np.frombuffer(h.to_bytes(32, "little"), dtype=np.uint8)
        r_bytes[i] = np.frombuffer(sig[:32], dtype=np.uint8)
    return E._windows_msb_first(s_raw, h_raw), keys, r_bytes


def entry(device=None):
    """(fn, example_args): the single-card forward step, K-W on eight
    signatures on `device` (the current card by default)."""
    dev = resolve(device)
    with on_device(dev):
        args = tuple(upload(a, dev) for a in _example_batch(8))
    return E.verify_windows, args


def _dryrun_qmaps():
    """The reference's dry-run maps: 6 orgs x 3 validators, inner sets 2 of
    3, top threshold 4 of 6 (safe) and 3 of 6 (splits)."""
    orgs = [[nid(10 * o + i) for i in range(3)] for o in range(6)]

    def top(thr):
        return qset(thr, inner=[qset(2, org) for org in orgs])

    return ({v: top(4) for org in orgs for v in org},
            {v: top(3) for org in orgs for v in org})


def shard_devices(n_devices: int, device=None):
    """Where the dry run's n shards go: round-robin over the visible cards
    by default (with one card, all on it); all on `device` when given, so
    device="cpu" makes n CPU shards."""
    if device is not None:
        return (resolve(device),) * n_devices
    first = resolve(None)
    count = torch.cuda.device_count()
    if count == 1:
        return (first,) * n_devices
    return tuple(torch.device("cuda", k % count) for k in range(n_devices))


def dryrun_multigpu(n_devices: int, *, device=None) -> dict:
    """Shard the verify step over n shards (contiguous parts of the batch,
    each verified by K-W with its accept count fused, the counts summed on
    the first device), then check the safe and splitting dry-run maps with
    the prune step sharded the same way.  Asserts the results; returns and
    prints a summary."""
    devices = shard_devices(n_devices, device)
    shards = Shards(devices)
    n = SHARD_SIGS * n_devices
    windows, keys, r_bytes = _example_batch(n)

    pending = []
    for k, (lo, hi) in enumerate(parts(n, n_devices)):
        with shards.on(k) as dev:
            count = torch.zeros(1, dtype=torch.int32, device=dev)
            ok = E.verify_windows(upload(windows[:, lo:hi], dev),
                                  upload(keys[lo:hi], dev),
                                  upload(r_bytes[lo:hi], dev), count=count)
        pending.append((ok, count, shards.join(k, ok, count)))
    # the psum: every shard's count summed on the first device
    first = devices[0]
    with on_device(first):
        total = torch.zeros(1, dtype=torch.int32, device=first)
        for _, count, _ in pending:
            total += count.to(first)
        total = int(total.item())
    ok = np.concatenate([o.cpu().numpy() for o, _, _ in pending])
    assert ok.shape == (n,)
    assert total == int(ok.sum()) == n, (
        f"multi-card verify wrong: {ok.tolist()} total={total}")

    # the quorum enumerator's prune step sharded over the same devices,
    # with a small batch so that every depth runs several chunks
    safe, split = _dryrun_qmaps()
    r1 = CudaQuorumIntersectionChecker(safe, batch_size=2 * n_devices,
                                       devices=devices).check()
    r2 = CudaQuorumIntersectionChecker(split, batch_size=2 * n_devices,
                                       devices=devices).check()
    assert r1.intersects and not r2.intersects, (r1, r2)

    cards = len({d for d in devices if d.type == "cuda"})
    summary = {"signatures": n, "shards": n_devices, "cards": cards,
               "accept_total": total, "safe_intersects": r1.intersects,
               "split_intersects": r2.intersects,
               "split_max_quorums_found": r2.max_quorums_found}
    where = f"{cards} card(s)" if cards else "the CPU"
    print(f"dryrun_multigpu OK: {n} sigs verified in {n_devices} shards on "
          f"{where}, accept count total={total}; quorum enumerator sharded "
          f"check: safe intersects={r1.intersects}, split intersects="
          f"{r2.intersects}", flush=True)
    return summary
