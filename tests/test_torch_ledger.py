"""The port's ledger layer against the reference's, byte for byte.

Each scenario is written once, as a function of the package root, and
runs on ``stellar_core_tpu`` and on ``stellar_core_tpu_torch`` with the
same seeded keys; the two runs' records (XDR bytes, hashes, error class
names) must be equal:

* ``ledger.ledger_txn``: nested commits and rollbacks, the deltas and the
  root's entries after each step;
* ``invariant``: hand-made close deltas (a transfer, lumens minted and
  burned, a negative balance, a wrong sub-entry count, an entry from a
  later ledger, a new account) held against each invariant and the
  InvariantManager: the same verdicts, messages and error class;
* ``herder.upgrades``: the header after each upgrade kind, voted through
  ``close_ledger`` (valid ones applied, invalid ones skipped), and the
  votes and checks of ``Upgrades``;
* ``history.archive`` and ``database``: the HistoryArchiveState's JSON,
  and ``enable_persistence`` then ``load_last_known_ledger`` in a
  temporary directory restoring the same ``lcl_hash`` and closing on; a
  file archive's states, buckets and XDR streams read back, the
  database's tables, and the close-cost ring of ``ledger.costs``;
* ``ledger.manager``: a replay-shaped chain (12 accounts, every 4th
  co-signed by an extra signer, 4 payments a ledger, 70 ledgers, so it
  crosses the checkpoint boundary at 63), the same per-ledger hash,
  result set and bucket list hash with invariants on and off, with native
  close attached on both sides and detached, and with the port's verify
  cache (or its engine's) seeded from the port's ``verify_batch`` on the
  CPU.

The reference's own tests of tests/test_ledger_txn.py and
tests/test_invariant.py also run on both packages (test_torch_mirror): an
invariant's verdict on the same delta, its error class and message, must
be the reference's.
"""

import importlib
import random

import pytest
import torch

from test_torch_mirror import ROOTS, assert_mirrored, cases

PORT = "stellar_core_tpu_torch"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions are many small tensor operations: one thread
    each runs them as fast as eight, and six test workers of eight
    threads each on one machine slow them a hundredfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _m(root, name):
    return importlib.import_module(f"{root}.{name}")


def _header(X, seq=1):
    return X.LedgerHeader(
        ledgerVersion=23, previousLedgerHash=b"\x00" * 32,
        scpValue=X.StellarValue(txSetHash=b"\x00" * 32, closeTime=0),
        txSetResultHash=b"\x00" * 32, bucketListHash=b"\x00" * 32,
        ledgerSeq=seq, totalCoins=10 ** 15, feePool=0, inflationSeq=0,
        idPool=0, baseFee=100, baseReserve=100000000, maxTxSetSize=100,
        skipList=[b"\x00" * 32] * 4)


def _entry(X, n, balance):
    return X.LedgerEntry(
        lastModifiedLedgerSeq=1,
        data=X.LedgerEntryData.account(X.AccountEntry(
            accountID=X.AccountID.ed25519(bytes([n]) * 32),
            balance=balance, seqNum=1)))


def _delta(d):
    return sorted((k, None if v is None else v.to_xdr()) for k, v in d.items())


def ledger_txn(root):
    X = _m(root, "xdr")
    T = _m(root, "ledger.ledger_txn")
    rng = random.Random(17)
    top = T.LedgerTxnRoot(_header(X))
    rec = []
    for step in range(30):
        outer = T.LedgerTxn(top)
        for _ in range(rng.randrange(1, 5)):
            n = rng.randrange(12)
            key = X.ledger_entry_key(_entry(X, n, 0))
            if outer.exists(key):
                if rng.random() < 0.3:
                    outer.erase(key)
                else:
                    outer.update(_entry(X, n, rng.randrange(10 ** 6)))
            else:
                outer.create(_entry(X, n, rng.randrange(10 ** 6)))
        inner = T.LedgerTxn(outer)
        n = rng.randrange(12)
        key = X.ledger_entry_key(_entry(X, n, 0))
        if inner.exists(key):
            inner.erase(key)
        else:
            inner.create(_entry(X, n, 7))
        header = inner.load_header()
        header.feePool += step
        inner.commit_header(header)
        rec.append(("inner", _delta(inner.delta())))
        inner.commit() if rng.random() < 0.6 else inner.rollback()
        rec.append(("outer", _delta(outer.delta()),
                    outer.get_header().to_xdr()))
        outer.commit() if rng.random() < 0.7 else outer.rollback()
        rec.append(("root", sorted((k, top.get_entry(k).to_xdr())
                                   for k in top.all_keys()),
                    top.get_header().to_xdr()))
    try:
        with T.LedgerTxn(top) as ltx:
            ltx.create(_entry(X, 0, 1))
            ltx.create(_entry(X, 0, 1))
    except Exception as e:
        rec.append(type(e).__name__)
    return rec


def invariants(root):
    """Hand-made close deltas, each held against every invariant alone and
    against the InvariantManager: accepted, or the message and the error
    class it raises."""
    X = _m(root, "xdr")
    I = _m(root, "invariant.invariants")
    T = _m(root, "ledger.ledger_txn")

    def acct(n, balance, sub=0, seq=1):
        e = _entry(X, n, balance)
        e.data.value.numSubEntries = sub
        e.lastModifiedLedgerSeq = seq
        return e

    def key(n):
        return X.ledger_entry_key(_entry(X, n, 0)).to_xdr()

    top = T.LedgerTxnRoot(_header(X))
    pre = {key(1): acct(1, 1000), key(2): acct(2, 500)}
    top._apply_delta(dict(pre), None)
    deltas = {
        "transfer": {key(1): acct(1, 900, seq=2), key(2): acct(2, 600, seq=2)},
        "minted": {key(1): acct(1, 5000, seq=2)},
        "burned": {key(2): None},
        "negative": {key(1): acct(1, -5, seq=2), key(2): acct(2, 1505, seq=2)},
        "subentries": {key(2): acct(2, 500, sub=3, seq=2)},
        "from the future": {key(1): acct(1, 1000, seq=99)},
        "created": {key(3): acct(3, 0, seq=2)},
    }
    rec = []
    for name, post in deltas.items():
        post_header = _header(X, seq=2)
        ctx = I.LedgerCloseContext(
            pre={k: top.get_entry(k) for k in post}, post=post,
            pre_header=_header(X), post_header=post_header,
            root_get=top.get_entry, all_keys=lambda: list(top.all_keys()))
        for inv in I.ALL_INVARIANTS:
            if inv.NEEDS_BUCKETS:
                continue
            try:
                rec.append((name, inv.NAME, inv().check_on_ledger_close(ctx)))
            except Exception as e:  # an invariant's own failure, compared
                rec.append((name, inv.NAME, type(e).__name__, str(e)))
        try:
            I.InvariantManager().check_on_ledger_close(ctx,
                                                       needs_buckets=False)
            rec.append((name, "accepted"))
        except I.InvariantDoesNotHold as e:
            rec.append((name, type(e).__name__, str(e)))
    rec.append(sorted(c.NAME for c in I.ALL_INVARIANTS))
    rec.append([c.NAME for c in I.InvariantManager.from_patterns(
        ["Conservation.*", ".*Valid"]).invariants])
    return rec


def _manager(root, nid_name, invariants=True):
    X = _m(root, "xdr")
    LM = _m(root, "ledger.manager").LedgerManager
    tu = _m(root, "testutils")
    nid = tu.network_id(nid_name)
    mgr = LM(nid) if invariants else LM(nid, invariant_manager=None)
    mgr.start_new_ledger()
    rsk = mgr.root_account_secret()
    e = mgr.root.get_entry(X.account_key_xdr(rsk.public_key.ed25519))
    return mgr, tu.TestAccount(mgr, rsk, e.data.value.seqNum)


def upgrades(root):
    X = _m(root, "xdr")
    U = _m(root, "herder.upgrades")
    mgr, _ = _manager(root, "torch upgrades net")
    UT = X.LedgerUpgradeType
    votes = [X.LedgerUpgrade.newBaseFee(200),
             X.LedgerUpgrade.newMaxTxSetSize(500),
             X.LedgerUpgrade.newBaseReserve(50_000_000),
             X.LedgerUpgrade.newLedgerVersion(22),     # a downgrade: skipped
             X.LedgerUpgrade.newBaseFee(0),            # invalid: skipped
             X.LedgerUpgrade(UT.LEDGER_UPGRADE_FLAGS, 1)]
    rec = []
    for i, up in enumerate(votes):
        blob = up.to_xdr()
        rec.append((U.Upgrades.describe(blob),
                    U.Upgrades().is_valid(blob, mgr.lcl_header, False)))
        _, h, _ = mgr.make_tx_set([])
        sv = X.StellarValue(txSetHash=h, closeTime=100 + i, upgrades=[blob])
        mgr.close_ledger([], 100 + i, stellar_value=sv)
        rec.append((mgr.lcl_hash, mgr.lcl_header.to_xdr()))
    rec.append(U.Upgrades.describe(b"\x00\x00\x00\x63"))
    want = U.Upgrades(U.UpgradeParameters(
        upgrade_time=50, protocol_version=23, base_fee=300,
        max_tx_set_size=500, base_reserve=10 ** 7))
    rec.append(want.create_upgrades_for(mgr.lcl_header, 60))
    rec.append(want.create_upgrades_for(mgr.lcl_header, 40))
    rec.append([want.is_valid(b, mgr.lcl_header, True, 60)
                for b in want.create_upgrades_for(mgr.lcl_header, 60)])
    rec.append(sorted(want.pending_json().items()))
    return rec


def persistence(root, tmp):
    X = _m(root, "xdr")
    tu = _m(root, "testutils")
    A = _m(root, "history.archive")
    D = _m(root, "database")
    BM = _m(root, "bucket.manager")
    LM = _m(root, "ledger.manager").LedgerManager
    SK = _m(root, "crypto.keys").SecretKey
    mgr, top = _manager(root, "torch persistence net")
    base = tmp / root
    db_path = str(base / "node.db")
    base.mkdir(parents=True)
    mgr.enable_persistence(D.Database(db_path), BM.BucketDir(str(base / "b")))
    sks = [SK(bytes([40 + i]) * 32) for i in range(4)]
    mgr.close_ledger([top.tx([tu.create_account_op(
        X.AccountID.ed25519(sk.public_key.ed25519), 10 ** 10)
        for sk in sks])], 10)
    rng = random.Random(8)
    rec = []
    for t in range(20):
        frames = [top.tx([tu.native_payment_op(
            X.AccountID.ed25519(sks[rng.randrange(4)].public_key.ed25519),
            1 + rng.randrange(10 ** 5))])]
        mgr.close_ledger(frames, 20 + t)
        rec.append(mgr.lcl_hash)
    has = A.HistoryArchiveState.from_bucket_list(
        mgr.last_closed_ledger_seq, "torch persistence net", mgr.bucket_list)
    rec.append(has.to_json())
    rec.append(A.HistoryArchiveState.from_json(has.to_json()).to_json())
    rec.append(has.all_bucket_hashes())
    rec.append([A.is_checkpoint_boundary(s) for s in (62, 63, 64, 127)])
    rec.append(A.category_path("ledger", 63))
    mgr.db.close()
    back = LM.load_last_known_ledger(mgr.network_id, D.Database(db_path),
                                     BM.BucketDir(str(base / "b")))
    rec.append((back.lcl_hash == mgr.lcl_hash, back.lcl_hash,
                back.bucket_list.hash()))
    acct = tu.TestAccount(back, top.secret, top.seq_num)
    for t in range(5):
        back.close_ledger([acct.tx([tu.native_payment_op(
            X.AccountID.ed25519(sks[t % 4].public_key.ed25519), 5)])],
            100 + t)
        rec.append(back.lcl_hash)
    back.db.close()
    return rec


def records(root, tmp):
    """The other record keepers a close feeds: the close-cost ring (fed
    the same seeded records), a file history archive (HAS, XDR streams,
    buckets put and read back) and the database's tables."""
    X = _m(root, "xdr")
    C = _m(root, "ledger.costs")
    A = _m(root, "history.archive")
    B = _m(root, "bucket.bucket")
    D = _m(root, "database")
    rng = random.Random(21)
    rec = []
    ring = C.CloseCostLedger(capacity=16)
    for seq in range(2, 40):
        ring.add(seq=seq, txs=rng.randrange(50), total_s=rng.random(),
                 fee_s=0.5, apply_s=0.25, seal_s=0.125,
                 merge_stall_s=0.0, cache_hits=rng.randrange(9),
                 cache_misses=1, pin_count=2, resident_entries=seq * 3,
                 resident_delta=3, gc_backlog=seq % 8)
    rec += [len(ring), ring.next_since, ring.doc(30), ring.recent(3),
            ring.window(30, 33), ring.latest()]
    arch = A.FileHistoryArchive(str(tmp / root / "archive"))
    bucket = B.Bucket.fresh(23, [_entry(X, n, n) for n in range(5)], [], [])
    has = A.HistoryArchiveState(63, "torch net", [
        {"curr": bucket.hash().hex(), "snap": "00" * 32, "next": None}] * 11)
    arch.put_state(has)
    arch.put_bucket(bucket)
    streams = [X.ledger_entry_key(_entry(X, n, 0)).to_xdr() for n in range(4)]
    arch.put_xdr_file(A.category_path("ledger", 63), streams)
    rec += [arch.get_state(63).to_json(), arch.get_state().to_json(),
            arch.get_bucket(bucket.hash().hex()).serialize(),
            arch.get_xdr_file(A.category_path("ledger", 63)),
            arch.exists(A.bucket_path(bucket.hash().hex())),
            A.unpack_xdr_stream(A.pack_xdr_stream(streams)).__next__(),
            sorted(str(q.relative_to(tmp / root / "archive"))
                   for q in (tmp / root / "archive").rglob("*") if q.is_file())]
    db = D.Database(str(tmp / root / "node.db"))
    for seq in range(1, 6):
        h = _header(X, seq)
        db.store_header(bytes([seq]) * 32, h)
        db.save_tx_history(seq, b"tx%d" % seq, b"res%d" % seq)
    db.set_state(D.PersistentState.LAST_CLOSED_LEDGER, "ab" * 32)
    db.queue_publish(63, has.to_json())
    db.store_peer("10.0.0.1", 11625, 2)
    db.commit()
    rec += [db.max_header_seq(), db.load_header_by_seq(3)[0],
            db.load_header_by_hash(bytes([4]) * 32).to_xdr(),
            db.load_tx_history(2, 4), db.publish_queue(), db.load_peers(),
            db.get_state(D.PersistentState.LAST_CLOSED_LEDGER),
            D.SCHEMA_VERSION]
    db.delete_old_headers(4)
    db.prune_tx_history(3)
    rec += [db.max_header_seq(), db.load_header_by_seq(2),
            db.load_tx_history(1, 5)]
    db.close()
    return rec


# -- the replay-shaped chain ---------------------------------------------------

CHAIN_ACCOUNTS, CHAIN_MULTISIG_EVERY, CHAIN_TXS, CHAIN_LEDGERS = 12, 4, 4, 70


def chain_frames(root, mgr, top):
    """bench.py's replay archive at a small size: a creation ledger, a
    setOptions ledger giving every 4th account an extra signer, then
    CHAIN_LEDGERS ledgers of CHAIN_TXS native payments each, drawn with
    random.Random(11); the co-signed accounts' payments carry both
    signatures.  Returns each ledger's frames and the (pk, sig, hash)
    pairs of the payment ledgers' signatures."""
    X = _m(root, "xdr")
    tu = _m(root, "testutils")
    SK = _m(root, "crypto.keys").SecretKey
    sks = [SK(bytes([1 + i]) * 31 + b"\x00") for i in range(CHAIN_ACCOUNTS)]
    ledgers = [[top.tx([tu.create_account_op(
        X.AccountID.ed25519(sk.public_key.ed25519), 10 ** 12)
        for sk in sks])]]
    # created in ledger 2: seqNum = 2 << 32
    accts = [tu.TestAccount(mgr, sk, 2 << 32) for sk in sks]
    extras = {i: SK(bytes([200 + i]) * 31 + b"\x00")
              for i in range(0, CHAIN_ACCOUNTS, CHAIN_MULTISIG_EVERY)}
    ledgers.append([accts[i].tx([X.Operation(
        body=X.OperationBody.setOptionsOp(X.SetOptionsOp(signer=X.Signer(
            key=X.SignerKey.ed25519(ex.public_key.ed25519), weight=1))))])
        for i, ex in extras.items()])
    rng = random.Random(11)
    pairs = []
    for _ in range(CHAIN_LEDGERS):
        frames = []
        for _ in range(CHAIN_TXS):
            i = rng.randrange(CHAIN_ACCOUNTS)
            a = accts[i]
            op = tu.native_payment_op(
                accts[rng.randrange(CHAIN_ACCOUNTS)].account_id,
                1000 + rng.randrange(10 ** 6))
            signers = [a.secret] + ([extras[i]] if i in extras else [])
            f = tu.build_tx(mgr.network_id, a.secret, a.next_seq(), [op],
                            signers=signers)
            h = f.content_hash()
            pairs += [(sk.public_key.ed25519, d.signature, h)
                      for sk, d in zip(signers, f.envelope.value.signatures)]
            frames.append(f)
        ledgers.append(frames)
    return ledgers, pairs


def chain(root, invariants=True, native=False, seeded=False):
    mgr, top = _manager(root, "torch chain net", invariants)
    if native:
        assert mgr.attach_native_close()
    ledgers, pairs = chain_frames(root, mgr, top)
    misses = None
    if seeded:
        # the port's verdicts, from its plain verify on the CPU
        ed = _m(root, "accel.ed25519")
        pks, sigs, msgs = (list(c) for c in zip(*pairs))
        verdicts = ed.verify_batch(pks, sigs, msgs, device="cpu",
                                   chunk_size=512, hot_threshold=1 << 62)
        assert verdicts.all()
        if native:
            mgr.native_closer.bridge.seed_verdicts(pks, sigs, msgs, verdicts)
        else:
            keys = _m(root, "crypto.keys")
            keys.clear_verify_cache()
            keys.seed_verify_cache(zip(pks, sigs, msgs,
                                       (bool(v) for v in verdicts)))
    reg = _m(root, "util.metrics").registry()
    recompute = reg.counter("crypto.verify.recompute").value
    rec = []
    for t, frames in enumerate(ledgers):
        arts = mgr.close_ledger(frames, 1_600_000_000 + 5 * t)
        rec.append((mgr.lcl_header.ledgerSeq, mgr.lcl_hash,
                    arts.result_entry.txResultSet.to_xdr(),
                    mgr.bucket_list.hash()))
    if seeded:
        if native:
            stats = mgr.native_closer.bridge.stats()
            misses = stats["verify_cache_misses"]
        else:
            misses = reg.counter("crypto.verify.recompute").value - recompute
            _m(root, "crypto.keys").clear_verify_cache()
    if native:
        mgr.detach_native_close()
        rec.append(("detached", mgr.lcl_hash, mgr.bucket_list.hash()))
    return rec, misses


@pytest.mark.parametrize("invariants, native, seeded", [
    (True, False, False), (False, False, False), (False, True, False),
    (False, False, True), (False, True, True)],
    ids=["invariants", "no-invariants", "native", "seeded", "native-seeded"])
def test_replay_shaped_chain_on_both_packages(invariants, native, seeded):
    native_apply = _m(PORT, "ledger.native_apply")
    if native and not native_apply.native_apply_available():
        pytest.skip("the native engine needs libsodium, which is missing")
    ref, _ = chain(ROOTS[0], invariants, native)
    port, misses = chain(PORT, invariants, native, seeded)
    assert len(ref) == CHAIN_LEDGERS + 2 + native
    assert [r[0] for r in ref[:-1]][-1] > 63   # past a checkpoint boundary
    for a, b in zip(port, ref):
        assert a == b
    assert len(port) == len(ref)
    if seeded:
        # the seeded verdicts answered every payment's signature check;
        # the set-up ledgers' 4 signatures (the creation, 3 setOptions)
        # were not seeded
        assert misses == 4


@pytest.mark.parametrize("scenario", [ledger_txn, upgrades, invariants],
                         ids=["ledger_txn", "upgrades", "invariants"])
def test_ledger_scenario_on_both_packages(scenario):
    ref, port = (scenario(root) for root in ROOTS)
    assert len(ref) > 5
    assert port == ref


def test_persistence_on_both_packages(tmp_path):
    ref, port = (persistence(root, tmp_path) for root in ROOTS)
    assert ref[-6][0] is True
    assert port == ref


def test_record_keepers_on_both_packages(tmp_path):
    ref, port = (records(root, tmp_path) for root in ROOTS)
    assert ref[0] == 16 and ref[-2] is None and len(ref[-1]) == 3
    assert port == ref


@pytest.mark.parametrize("filename, case", [
    (f, c) for f in ("test_ledger_txn.py", "test_invariant.py")
    for c in cases(f)])
def test_reference_ledger_tests_on_both_packages(filename, case):
    assert_mirrored(filename, case)
