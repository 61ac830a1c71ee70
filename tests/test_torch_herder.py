"""The port's live-node slice against the reference's, on the CPU.

Every comparison is exact equality (hashes, XDR bytes, counts, node lists
in order, strings):

1. a standalone validator (``Herder`` on a VIRTUAL_TIME clock, a singleton
   quorum set, admission on, accel on; 12 seed-derived accounts, 4
   ledgers, a burst of 12 payments before each trigger, ``batch_size=8``,
   ``accel_min_sigs=4``) on both packages: the same ledger hashes, tx-set
   hashes, result sets, admission stats and herder state transitions;
2. ``AdmissionCampaign(64 accounts)`` with accel on, ``run(3, 40)``: the
   same statuses, ledger hashes and stats;
3. the quorum checker's host functions (``check_intersection``,
   ``project_out_faulty``, ``intersection_critical_groups`` and the
   symmetric org contraction) on the maps of tests/test_quorum_intersection
   .py, with the native enumeration core and without it (the reference's
   switch: ``_cquorum`` None, as STELLAR_TPU_NO_CQUORUM leaves it);
4. ``check-quorum-intersection`` on a JSON map: the same standard output and
   exit code as the reference's command line;
5. the rules of the card: with no CUDA and no "cpu" asked for, admission,
   the herder's admission and the campaign raise; on a device marked
   CUDA a warm job that raised fails its collect.

Accel on means the port's plain versions (``accel_device="cpu"`` /
``PreverifyPipeline.DEFAULT_DEVICE = "cpu"``) and the reference's jitted
verify on jax's CPU, as tests/test_torch_catchup.py runs it: both with a
race budget no collect misses, a 256-signature chunk (one compiled shape
on jax's side) and the warm batch waited for before the first submission,
so the batches go to the same place in both.
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import random
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from stellar_core_tpu.herder import quorum_intersection as ref_qi
from stellar_core_tpu_torch.herder import quorum_intersection as port_qi

ROOT = Path(__file__).resolve().parent.parent
ROOTS = ("ref", "port")


def package(root: str):
    """The modules of one package that the scenarios use."""
    name = {"ref": "stellar_core_tpu", "port": "stellar_core_tpu_torch"}[root]
    mods = {m: importlib.import_module(f"{name}.{p}") for m, p in (
        ("X", "xdr"), ("keys", "crypto.keys"), ("sha", "crypto.sha"),
        ("herder", "herder.herder"), ("admission", "herder.admission"),
        ("scpq", "scp.quorum"), ("loadgen", "simulation.loadgen"),
        ("clock", "util.clock"), ("ledger", "ledger.manager"),
        ("testutils", "testutils"), ("catchup", "catchup.catchup"),
        ("metrics", "util.metrics"))}
    return types.SimpleNamespace(**mods)


PKG = {root: package(root) for root in ROOTS}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """The plain versions are many small operations: one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def accel_in_both(monkeypatch):
    """Accel admission comparable across the packages: the port on the
    plain versions, both with a race budget no collect misses and a chunk
    of 256 signatures (the jitted verify's one shape)."""
    for root in ROOTS:
        pipe = PKG[root].catchup.PreverifyPipeline
        monkeypatch.setattr(pipe, "RACE_CPU_S_PER_SIG", 10.0)
        adm = PKG[root].admission.AdmissionPipeline
        monkeypatch.setattr(adm, "__init__", functools.partialmethod(
            adm.__init__, accel_chunk=256))
    monkeypatch.setattr(PKG["port"].catchup.PreverifyPipeline,
                        "DEFAULT_DEVICE", "cpu")


def wait_warm(pipe, timeout: float = 300.0) -> None:
    """Until the pipeline's warm batch has its verdicts (jax's compile on
    the reference's side)."""
    deadline = time.monotonic() + timeout
    while not pipe._preverify.job_done(pipe._warm_id):
        assert time.monotonic() < deadline, "the warm batch never finished"
        time.sleep(0.01)


def counts(stats: dict) -> dict:
    """A stats dict without its timings."""
    return {k: v for k, v in stats.items() if not isinstance(v, float)}


# -- 1. the standalone validator ------------------------------------------

def standalone_validator(root: str, n_accounts: int = 12, n_ledgers: int = 4,
                         burst: int = 12, accel: bool = True) -> dict:
    """A Herder with a singleton quorum set closing `n_ledgers` ledgers
    by SCP on `root`'s package, each after a burst of `burst` payments
    (distinct sources) through recv_transaction and a drained admission;
    returns what two runs of it must share."""
    p = PKG[root]
    p.keys.clear_verify_cache()
    p.metrics.reset_registry()
    nid = p.sha.sha256(b"torch herder differential net")
    clock = p.clock.VirtualClock(p.clock.ClockMode.VIRTUAL_TIME)
    lm = p.ledger.LedgerManager(nid, invariant_manager=None)
    lm.start_new_ledger()
    lm.lcl_header.maxTxSetSize = 1000
    pool = p.loadgen.SeedAccountPool(n_accounts, seed=5)
    p.loadgen.LoadGenerator(lm, seed=5, clock=clock).install_account_pool(
        pool)
    node = p.keys.SecretKey(p.sha.sha256(b"torch herder validator"))
    herder = p.herder.Herder(clock, lm, node,
                             p.scpq.singleton_qset(node.public_key.ed25519))
    herder.enable_admission(accel=accel, batch_size=8, max_backlog=2000,
                            accel_min_sigs=4)
    transitions = []
    set_state = herder._set_state

    def recorded(state, why):
        if state != herder.state:
            transitions.append((herder.state, state, why))
        set_state(state, why)

    herder._set_state = recorded
    closed = []
    herder.ledger_closed_hook = closed.append
    if accel:
        wait_warm(herder.admission)
    rng = random.Random(5)
    statuses, ledgers = [], []
    try:
        for k in range(n_ledgers):
            for i in rng.sample(range(n_accounts), burst):
                frame = p.testutils.build_tx(
                    nid, pool.secret(i), pool.next_seq(i),
                    [p.testutils.native_payment_op(
                        pool.account_id(rng.randrange(n_accounts)), 100)],
                    fee=100 + rng.randrange(200))
                statuses.append(herder.recv_transaction(frame).code)
            herder.admission.drain()
            if k == 0:
                herder.bootstrap()
            for _ in range(10_000):
                if len(closed) == k + 1:
                    break
                clock.crank()
            arts = closed[k]
            header = arts.header_entry.header
            ledgers.append((header.ledgerSeq, arts.header_entry.hash,
                            header.scpValue.txSetHash,
                            header.scpValue.closeTime,
                            arts.result_entry.txResultSet.to_xdr(),
                            herder.tx_queue.size))
    finally:
        herder.admission.close()
    return {"ledgers": ledgers, "statuses": statuses,
            "transitions": transitions, "state": herder.state,
            "stats": counts(herder.admission.stats),
            "warmed": herder.admission._warmed}


def test_standalone_validator_equals_reference(accel_in_both):
    port = standalone_validator("port")
    ref = standalone_validator("ref")
    assert port == ref
    assert len(port["ledgers"]) == 4
    assert port["warmed"]
    assert port["transitions"] == [("booting", "tracking", "bootstrap")]
    # every burst admitted and applied; batches of >= 4 went to the device
    assert all(queued == 0 for *_, queued in port["ledgers"])
    assert port["stats"]["admitted"] == 48
    assert port["stats"]["sigs_offloaded"] >= 4 * 8
    assert port["stats"]["sigs_shipped"] > 0


def test_standalone_validator_accel_off_equals_accel_on(accel_in_both):
    """The port's own oracle comparison, as chip_smoke.py's consensus phase
    makes it: the same ledgers with accel off."""
    on, off = standalone_validator("port"), standalone_validator(
        "port", accel=False)
    assert (on["ledgers"], on["statuses"], on["transitions"]) \
        == (off["ledgers"], off["statuses"], off["transitions"])
    assert off["stats"]["sigs_offloaded"] == 0


# -- 2. the admission campaign --------------------------------------------

def campaign(root: str) -> dict:
    """AdmissionCampaign(64 accounts, batch_size=16, accel) on `root`'s
    package, accel_min_sigs 4, run(3, 40) after the warm batch: its
    report's counts, statuses, ledger hashes and stats."""
    p = PKG[root]
    p.keys.clear_verify_cache()
    p.metrics.reset_registry()
    c = p.loadgen.AdmissionCampaign(n_accounts=64, accel=True,
                                    batch_size=16, max_tx_set_ops=60)
    c.admission.accel_min_sigs = 4
    hashes = []
    close = c.mgr.close_ledger

    def recorded(*args, **kw):
        arts = close(*args, **kw)
        hashes.append((arts.header_entry.hash,
                       arts.result_entry.txResultSet.to_xdr()))
        return arts

    c.mgr.close_ledger = recorded
    try:
        wait_warm(c.admission)
        rep = c.run(n_ledgers=3, offered_per_ledger=40)
    finally:
        c.close()
    keep = ("accounts", "accounts_touched", "ledgers", "offered", "applied",
            "statuses", "peak_queue_depth", "peak_admission_depth",
            "backpressure_engaged", "batches")
    return {"report": {k: rep.get(k) for k in keep},
            "statuses": c.statuses, "hashes": hashes,
            "stats": counts(c.admission.stats)}


def test_admission_campaign_equals_reference(accel_in_both):
    port, ref = campaign("port"), campaign("ref")
    assert port == ref
    assert len(port["hashes"]) == 3
    assert port["stats"]["sigs_offloaded"] > 0
    assert port["report"]["applied"] > 0


# -- 3. the quorum checker's host functions -------------------------------

def nid(i: int) -> bytes:
    return bytes([i]) + bytes(31)


def qset(X, threshold, validators=(), inner=()):
    return X.SCPQuorumSet(threshold=threshold,
                          validators=[X.NodeID.ed25519(v) for v in validators],
                          innerSets=list(inner))


def org_qmap(X, n_orgs: int, top: int, per_org: int = 3, inner: int = 2):
    orgs = [[nid(10 * o + i) for i in range(per_org)] for o in range(n_orgs)]
    q = qset(X, top, inner=[qset(X, inner, org) for org in orgs])
    return {v: q for org in orgs for v in org}, orgs


def tier1(X, n_orgs: int, per_org: int = 3, outer=None, inner_thr: int = 2):
    """test_quorum_intersection.py's TestSymmetricOrgContraction._tier1."""
    ids = [bytes([o + 1]) * 31 + bytes([v])
           for o in range(n_orgs) for v in range(per_org)]
    inner = [X.SCPQuorumSet(
        threshold=inner_thr,
        validators=[X.NodeID.ed25519(ids[o * per_org + v])
                    for v in range(per_org)],
        innerSets=[]) for o in range(n_orgs)]
    q = X.SCPQuorumSet(threshold=outer if outer else (2 * n_orgs + 2) // 3,
                       validators=[], innerSets=inner)
    return {n: q for n in ids}


def qmaps(X) -> dict:
    """The maps of tests/test_quorum_intersection.py, by name."""
    def flat(n, t, ids=None):
        ids = ids or [nid(i) for i in range(n)]
        return {v: qset(X, t, ids) for v in ids}

    a3, b3 = [nid(i) for i in range(3)], [nid(10 + i) for i in range(3)]
    core = [nid(i) for i in range(4)]
    asym = flat(4, 3, core)
    asym[nid(9)] = qset(X, 3, core)
    ids6 = [nid(i) for i in range(6)]
    deep = qset(X, 2, [ids6[0]], inner=[qset(X, 2, ids6[0:3], inner=[
        qset(X, 2, ids6[3:6])])])
    rng = random.Random(1234)
    randoms = {}
    for trial in range(6):
        n = rng.randrange(3, 10)
        ids = [nid(i) for i in range(n)]
        m = {}
        for v in ids:
            peers = rng.sample(ids, rng.randrange(2, n + 1))
            if v not in peers:
                peers.append(v)
            m[v] = qset(X, rng.randrange(1, len(peers) + 1), peers)
        randoms[f"random{trial}"] = m
    maps = {
        "majority": flat(4, 3), "below_majority": flat(4, 2),
        "flat_7_4": flat(7, 4), "flat_6_3": flat(6, 3),
        "disjoint_sccs": {**{v: qset(X, 2, a3) for v in a3},
                          **{v: qset(X, 2, b3) for v in b3}},
        "single_node": {nid(1): qset(X, 1, [nid(1)])},
        "no_quorum": {nid(1): qset(X, 2, [nid(1), nid(2)]), nid(2): None},
        "org_intersects": org_qmap(X, 3, 2)[0],
        "org_splits": org_qmap(X, 4, 2)[0],
        "tier1_like": org_qmap(X, 7, 5)[0],
        "asymmetric": asym, "deep_nesting": {v: deep for v in ids6},
        "tier1_9": tier1(X, 9), "tier1_24": tier1(X, 24),
        "tier1_split": tier1(X, 9, outer=3),
        "tier1_weak_inner": tier1(X, 4, inner_thr=1, outer=3),
        **{f"tier1_{n}_{o}": tier1(X, n, outer=o)
           for n, o in ((3, 2), (4, 2), (4, 3), (5, 3))},
        **randoms}
    return maps


def result_fields(res) -> tuple:
    return (res.intersects, res.split, res.node_count, res.main_scc_size,
            res.max_quorums_found)


@pytest.fixture(params=["native", "python"])
def enumeration(request, monkeypatch):
    """The native core in both packages, or in neither: STELLAR_TPU_NO_CQUORUM
    leaves each module's _cquorum None, which is what this sets."""
    if request.param == "native":
        assert ref_qi._cquorum is not None and port_qi._cquorum is not None
    else:
        for mod in (ref_qi, port_qi):
            monkeypatch.setattr(mod, "_cquorum", None)
    return request.param


def test_check_intersection_equals_reference(enumeration):
    ref_maps = qmaps(PKG["ref"].X)
    port_maps = qmaps(PKG["port"].X)
    assert ref_maps.keys() == port_maps.keys()
    for name in ref_maps:
        want = ref_qi.check_intersection(ref_maps[name])
        got = port_qi.check_intersection(port_maps[name])
        assert result_fields(got) == result_fields(want), name
        if len(ref_maps[name]) > 15:
            continue        # the contraction's maps: exponential in orgs
        # the enumeration itself, past the org contraction
        want = ref_qi.QuorumIntersectionChecker(ref_maps[name]).check()
        got = port_qi.QuorumIntersectionChecker(port_maps[name]).check()
        assert result_fields(got) == result_fields(want), name
    assert not port_qi.check_intersection(port_maps["org_splits"]).intersects
    ids = [nid(i) for i in range(16)]
    with pytest.raises(port_qi.InterruptedError_):
        port_qi.check_intersection({v: qset(PKG["port"].X, 8, ids)
                                    for v in ids}, interrupt=lambda: True)


def test_org_contraction_equals_reference():
    ref_maps = qmaps(PKG["ref"].X)
    port_maps = qmaps(PKG["port"].X)
    contracted = 0
    for name in ref_maps:
        want = ref_qi._try_symmetric_org_contraction(ref_maps[name])
        got = port_qi._try_symmetric_org_contraction(port_maps[name])
        assert (got is None) == (want is None), name
        if got is not None:
            contracted += 1
            assert result_fields(got) == result_fields(want), name
    assert contracted >= 7


def test_project_out_faulty_and_critical_groups_equal_reference(
        enumeration):
    for top in (2, 3):
        for faulty_org in range(3):
            (rmap, rorgs), (pmap, porgs) = (org_qmap(PKG[r].X, 3, top)
                                            for r in ROOTS)
            faulty = set(rorgs[faulty_org])
            q_ref = next(iter(rmap.values()))
            q_port = next(iter(pmap.values()))
            assert port_qi.project_out_faulty(q_port, faulty).to_xdr() \
                == ref_qi.project_out_faulty(q_ref, faulty).to_xdr()
        groups = [set(o) for o in rorgs]
        got = port_qi.intersection_critical_groups(pmap, groups)
        want = ref_qi.intersection_critical_groups(rmap, groups)
        assert got == want
        assert len(got) == (3 if top == 2 else 0)
    # each of the small maps' first four nodes turned faulty alone
    for name, m in qmaps(PKG["port"].X).items():
        if len(m) > 12 or any(q is None for q in m.values()):
            continue
        groups = [{n} for n in sorted(m)][:4]
        want = ref_qi.intersection_critical_groups(qmaps(PKG["ref"].X)[name],
                                                   groups)
        assert port_qi.intersection_critical_groups(m, groups) == want, name


def test_no_cquorum_switch_leaves_the_python_enumeration():
    """STELLAR_TPU_NO_CQUORUM: the port's module loads no native core."""
    env = dict(os.environ, STELLAR_TPU_NO_CQUORUM="1")
    out = subprocess.run(
        [sys.executable, "-c",
         "from stellar_core_tpu_torch.herder import quorum_intersection as q;"
         " print(q._cquorum)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "None"


# -- 4. the command line --------------------------------------------------

def strkey(i: int) -> str:
    from stellar_core_tpu_torch.crypto.keys import PublicKey
    return PublicKey(nid(i)).to_strkey()


@pytest.mark.parametrize("threshold", [3, 2], ids=["intersects", "splits"])
def test_check_quorum_intersection_cli_equals_reference(tmp_path, threshold):
    nodes = [strkey(i) for i in range(4)]
    path = tmp_path / "qmap.json"
    path.write_text(json.dumps({n: {"threshold": threshold,
                                    "validators": nodes} for n in nodes}))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    runs = [subprocess.run(
        [sys.executable, "-m", pkg, "check-quorum-intersection", str(path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        for pkg in ("stellar_core_tpu", "stellar_core_tpu_torch")]
    ref, port = runs
    assert (port.returncode, port.stdout) == (ref.returncode, ref.stdout)
    assert port.returncode == (0 if threshold == 3 else 2)


# -- 5. the rules of the card ---------------------------------------------

def test_accel_admission_raises_without_cuda(monkeypatch):
    """With no device named and no CUDA, an accel admission pipeline, the
    herder's accel admission and an accel campaign raise: none admits on
    the CPU unless asked for."""
    p = PKG["port"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(p.catchup.PreverifyPipeline, "DEFAULT_DEVICE", None)
    lm = p.ledger.LedgerManager(p.sha.sha256(b"no card admission"))
    lm.start_new_ledger()
    clock = p.clock.VirtualClock(p.clock.ClockMode.VIRTUAL_TIME)
    from stellar_core_tpu_torch.herder.tx_queue import TransactionQueue
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.admission.AdmissionPipeline(TransactionQueue(lm), lm, clock,
                                      accel=True)
    node = p.keys.SecretKey(bytes([3]) * 32)
    herder = p.herder.Herder(clock, lm, node,
                             p.scpq.singleton_qset(node.public_key.ed25519))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        herder.enable_admission(accel=True)
    assert herder.admission is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.loadgen.AdmissionCampaign(n_accounts=4, accel=True)
    # asked for, the plain versions run; accel off needs no device
    adm = p.admission.AdmissionPipeline(TransactionQueue(lm), lm, clock,
                                        accel=True, accel_device="cpu")
    assert adm._preverify.devices == (torch.device("cpu"),)
    adm.close()
    herder.enable_admission(accel=False)
    assert herder.admission._preverify is None


@pytest.mark.parametrize("on_card", [True, False], ids=["cuda", "cpu"])
def test_a_warm_job_that_raised_fails_its_collect_on_the_card(monkeypatch,
                                                               on_card):
    """The warm batch's device job raises (as a kernel that does not build
    would).  On a device marked CUDA the collect that takes the warm
    verdicts raises CatchupError; on the plain versions it falls back to
    the CPU, as the reference does."""
    p = PKG["port"]
    catchup = p.catchup

    def gate(i):
        raise RuntimeError(f"K-G launch failed (group {i})")

    monkeypatch.setattr(catchup.PreverifyPipeline, "DEVICE_GATE",
                        staticmethod(gate))
    lm = p.ledger.LedgerManager(p.sha.sha256(b"failing warm job"))
    lm.start_new_ledger()
    clock = p.clock.VirtualClock(p.clock.ClockMode.VIRTUAL_TIME)
    clock.crank_for(1.0)
    from stellar_core_tpu_torch.herder.tx_queue import TransactionQueue
    adm = p.admission.AdmissionPipeline(TransactionQueue(lm), lm, clock,
                                        accel=True, accel_device="cpu",
                                        batch_size=2, accel_min_sigs=1)
    adm._preverify.raise_device_errors = on_card
    wait_warm(adm)
    root = lm.root_account_secret()
    seq = lm.root.get_entry(p.X.LedgerKey.account(p.X.LedgerKeyAccount(
        accountID=p.X.AccountID.ed25519(
            root.public_key.ed25519))).to_xdr()).data.value.seqNum
    frames = [p.testutils.build_tx(
        lm.network_id, p.keys.SecretKey(bytes([i + 1]) * 32), seq + 1,
        [p.testutils.native_payment_op(
            p.X.AccountID.ed25519(root.public_key.ed25519), 1)])
        for i in range(3)]
    try:
        adm.submit(frames[0])                    # the sync path
        if on_card:
            with pytest.raises(catchup.CatchupError, match="K-G launch"):
                adm.submit(frames[1])
                adm.submit(frames[2])            # a batch: flush, warm collect
        else:
            adm.submit(frames[1])
            adm.submit(frames[2])
            adm.drain()
            assert adm._warmed
            # the warm batch's and the dispatched batch's, both on the CPU
            assert adm.stats["collect_fallbacks"] == 2
    finally:
        adm.close()
