"""The port's bucket layer against the reference's, byte for byte.

Each scenario is written once, as a function of the package root, and
runs on ``stellar_core_tpu`` and on ``stellar_core_tpu_torch`` with the
same seeded entries (``random.Random``); the two runs' records, all XDR
bytes and hashes, must be equal:

* ``merge_buckets``: INIT / LIVE / DEAD pairs, shadowing, with and
  without tombstones, the merged buckets' bytes and hashes;
* ``BucketList.add_batch`` across level spills (300 ledgers, synchronous
  and with a thread pool of merges), the list's hash at every ledger;
* ``BucketIndex`` lookups and ``SearchableBucketListSnapshot`` reads
  (point, batched, scan) of live, dead and absent keys;
* the disk mode: ``BucketListStore`` files in a temporary directory, the
  streaming merges of the deep levels, and a ``LedgerManager`` closing
  on a disk root.

The reference's own tests of tests/test_bucket.py also run on both
packages (test_torch_mirror).
"""

import importlib
import random
from concurrent.futures import ThreadPoolExecutor

import pytest

from test_torch_mirror import ROOTS, assert_mirrored, cases

PROTO = 23


def _m(root, name):
    return importlib.import_module(f"{root}.{name}")


def _entry(X, n: int, balance: int, seq: int = 1):
    return X.LedgerEntry(
        lastModifiedLedgerSeq=seq,
        data=X.LedgerEntryData.account(X.AccountEntry(
            accountID=X.AccountID.ed25519(n.to_bytes(2, "big") * 16),
            balance=balance, seqNum=seq)))


def _batches(X, n_ledgers: int, n_keys: int, seed: int):
    """Per ledger (init, live, dead): new keys created, known ones updated
    or deleted, each key once a ledger."""
    rng = random.Random(seed)
    alive, out = set(), []
    for ledger in range(1, n_ledgers + 1):
        init, live, dead, used = [], [], [], set()
        for _ in range(rng.randrange(1, 6)):
            k = rng.randrange(n_keys)
            if k in used:
                continue
            used.add(k)
            if k not in alive:
                init.append(_entry(X, k, rng.randrange(10 ** 9), ledger))
                alive.add(k)
            elif rng.random() < 0.25:
                dead.append(X.ledger_entry_key(_entry(X, k, 0)))
                alive.discard(k)
            else:
                live.append(_entry(X, k, rng.randrange(10 ** 9), ledger))
        out.append((init, live, dead))
    return out


def merges(root):
    X = _m(root, "xdr")
    B = _m(root, "bucket.bucket")
    rng = random.Random(5)
    rec = []
    for trial in range(12):
        # old and new over 40 keys, each key in each bucket at most once,
        # as INIT, LIVE or DEAD (shadowing where both hold it)
        sides = []
        for _ in range(2):
            init, live, dead = [], [], []
            for k in rng.sample(range(40), rng.randrange(5, 30)):
                kind = rng.randrange(3)
                e = _entry(X, k, rng.randrange(10 ** 6), trial + 1)
                (init if kind == 0 else live if kind == 1 else dead).append(
                    e if kind < 2 else X.ledger_entry_key(e))
            sides.append(B.Bucket.fresh(PROTO, *[init, live, dead]))
        old, new = sides
        for keep in (True, False):
            m = B.merge_buckets(old, new, keep_tombstones=keep)
            rec.append((m.hash(), m.serialize(),
                        [be.switch for be in m.entries]))
        rec.append(B.merge_buckets(old, B.Bucket.empty()).hash())
        rec.append(B.Bucket.deserialize(old.serialize()).hash())
    return rec


def bucket_list(root, threaded: bool):
    X = _m(root, "xdr")
    BL = _m(root, "bucket.bucket_list")
    pool = ThreadPoolExecutor(4) if threaded else None
    try:
        bl = BL.BucketList(executor=pool)
        rec = []
        for seq, (init, live, dead) in enumerate(
                _batches(X, 300, 120, seed=9), start=1):
            bl.add_batch(seq, PROTO, init, live, dead)
            rec.append(bl.hash())
        bl.resolve_all_merges()
        rec.append([(lv.curr.hash(), lv.snap.hash()) for lv in bl.levels])
        rec.append(sorted(bl.referenced_hashes()))
        return rec
    finally:
        if pool is not None:
            pool.shutdown()


def reads(root):
    X = _m(root, "xdr")
    B = _m(root, "bucket.bucket")
    BL = _m(root, "bucket.bucket_list")
    rec = []
    b = B.Bucket.fresh(PROTO, [_entry(X, k, k) for k in range(0, 40, 2)],
                       [], [X.ledger_entry_key(_entry(X, 1, 0))])
    idx = b.index()
    for k in range(42):
        kb = X.ledger_entry_key(_entry(X, k, 0)).to_xdr()
        pos = idx.find(kb)
        rec.append((k, pos, idx.lower_bound(kb),
                    None if pos is None else b.entries[pos].to_xdr()))
    bl = BL.BucketList()
    for seq, batch in enumerate(_batches(X, 150, 60, seed=3), start=1):
        bl.add_batch(seq, PROTO, *batch)
    snap = bl.snapshot(ledger_seq=150)
    keys = [X.ledger_entry_key(_entry(X, k, 0)).to_xdr() for k in range(64)]
    for kb in keys:
        got = snap.load(kb)
        rec.append(None if got is None else got.to_xdr())
        latest = bl.lookup_latest(kb)
        rec.append(None if latest is None else latest.to_xdr())
    rec.append(sorted((k, v.to_xdr()) for k, v in snap.load_keys(keys).items()))
    rec.append(sorted(snap.iter_live_keys()))
    rec.append(sorted(e.to_xdr() for e in snap.scan()))
    rec.append(snap.live_entry_count())
    return rec


def disk_mode(root, tmp):
    X = _m(root, "xdr")
    BL = _m(root, "bucket.bucket_list")
    M = _m(root, "bucket.manager")
    store = M.BucketListStore(str(tmp / root / "buckets"))
    bl = BL.BucketList()
    # levels from 2 down are disk resident and merge file to file
    bl.configure_residency(store, 2)
    rec = []
    for seq, batch in enumerate(_batches(X, 260, 90, seed=4), start=1):
        bl.add_batch(seq, PROTO, *batch)
        bl.enforce_residency()
        rec.append(bl.hash())
    bl.resolve_all_merges()
    snap = bl.snapshot(260, store=store)
    for k in range(96):
        got = snap.load(X.ledger_entry_key(_entry(X, k, 0)))
        rec.append(None if got is None else got.to_xdr())
    snap.release()
    files = sorted(p.name for p in (tmp / root / "buckets").rglob("*.xdr"))
    rec.append(files)
    rec.append({name: (tmp / root / "buckets").rglob(name).__next__()
                .read_bytes() for name in files})
    return rec


def disk_root_chain(root, tmp):
    X = _m(root, "xdr")
    LM = _m(root, "ledger.manager").LedgerManager
    M = _m(root, "bucket.manager")
    tu = _m(root, "testutils")
    SK = _m(root, "crypto.keys").SecretKey
    nid = tu.network_id("torch bucket net")
    mgr = LM(nid, bucket_store=M.BucketListStore(str(tmp / root / "db")),
             resident_levels=1)
    mgr.start_new_ledger()
    rsk = mgr.root_account_secret()
    e = mgr.root.get_entry(X.account_key_xdr(rsk.public_key.ed25519))
    top = tu.TestAccount(mgr, rsk, e.data.value.seqNum)
    sks = [SK(bytes([i + 1]) * 32) for i in range(6)]
    rec = []
    mgr.close_ledger([top.tx([tu.create_account_op(
        X.AccountID.ed25519(sk.public_key.ed25519), 10 ** 10)
        for sk in sks])], 10)
    accts = [tu.TestAccount(mgr, sk, mgr.root.get_entry(X.account_key_xdr(
        sk.public_key.ed25519)).data.value.seqNum) for sk in sks]
    rng = random.Random(2)
    for t in range(40):
        frames = [a.tx([tu.native_payment_op(
            accts[rng.randrange(6)].account_id, 1 + rng.randrange(1000))])
            for a in rng.sample(accts, 3)]
        arts = mgr.close_ledger(frames, 20 + 5 * t)
        rec.append((mgr.lcl_hash, arts.result_entry.txResultSet.to_xdr(),
                    mgr.bucket_list.hash()))
    return rec


@pytest.mark.parametrize("scenario", [
    merges,
    reads,
    lambda root: bucket_list(root, threaded=False),
    lambda root: bucket_list(root, threaded=True),
], ids=["merge_buckets", "index_and_snapshot_reads", "add_batch_sync",
        "add_batch_threaded"])
def test_bucket_scenario_on_both_packages(scenario):
    ref, port = (scenario(root) for root in ROOTS)
    assert len(ref) > 10
    assert port == ref


@pytest.mark.parametrize("scenario", [disk_mode, disk_root_chain],
                         ids=["bucket_list_store", "disk_root_close"])
def test_disk_mode_on_both_packages(scenario, tmp_path):
    ref, port = (scenario(root, tmp_path) for root in ROOTS)
    assert len(ref) > 10
    assert port == ref


@pytest.mark.parametrize("case", cases("test_bucket.py"))
def test_reference_bucket_tests_on_both_packages(case):
    assert_mirrored("test_bucket.py", case)
