"""What of chip_smoke.py runs without a card: its pure-Python RFC 8032
signer equals libsodium byte for byte, its fixed adversarial verdicts are
libsodium's, its fixed quorum results are the JAX package's, its kernel
operation counts follow the device code, its main-path runs count launches
and kernel time per call, and the script refuses to run (exit 2, no
result) without CUDA and fails in a directory that holds only itself."""

import json
import os
import shutil
import signal
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from stellar_core_tpu_torch import _cuda_build
from stellar_core_tpu_torch.accel import ed25519, tables
from stellar_core_tpu_torch.crypto import rfc8032, sodium

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def libsodium():
    if not sodium.available():
        pytest.skip("libsodium is the oracle of these checks")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions are many small tensor operations: one thread
    each runs them as fast as eight, and six test workers of eight
    threads each on one machine slow them a hundredfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_python_signer_equals_libsodium(libsodium, monkeypatch):
    """The script signs through crypto/sodium.py, which falls back to the
    port's RFC 8032 code (crypto/rfc8032.py) where libsodium is missing:
    the same keys and signatures, byte for byte."""
    want = []
    for i in range(4):
        seed = bytes([i * 7 + 1]) * 32
        pk, sk = rfc8032.keypair(seed)
        assert (pk, sk) == sodium.sign_seed_keypair(seed)
        for msg in (b"", b"m", bytes(range(120))):
            want.append(sodium.sign_detached(msg, sk))
            assert rfc8032.sign(msg, sk) == want[-1]
    monkeypatch.setattr(sodium, "_lib", None)
    assert chip_smoke.signer_name() == "python-rfc8032"
    got = [sodium.sign_detached(msg, sodium.sign_seed_keypair(
        bytes([i * 7 + 1]) * 32)[1]) for i in range(4)
        for msg in (b"", b"m", bytes(range(120)))]
    assert got == want


def test_adversarial_constants_are_libsodiums(libsodium, monkeypatch):
    cases = chip_smoke.adversarial_cases()
    for name, triples, expected in cases:
        assert [sodium.verify_detached(s, m, p) for p, s, m in triples] == \
            expected, name
    # the fallback signer makes the very same vectors
    monkeypatch.setattr(chip_smoke.sodium, "_lib", None)
    assert chip_smoke.signer_name() == "python-rfc8032"
    assert chip_smoke.adversarial_cases() == cases


def test_operation_counts():
    # per signature / per key, from the field-op counts of csrc/verify.cuh
    assert chip_smoke.kt_imads() == 254 * 55 + 1037 * 100
    assert chip_smoke.kg_imads() == 1274 * 55 + 2144 * 100
    # K-B's bound counts what the build needs (x*y once, the 252-doubling
    # chain, 127 multiplies a window: 14 precomputed adds and 15 entries)
    assert chip_smoke.kb_imads() == 1008 * 55 + (1 + 1008 + 64 * 127) * 100
    assert chip_smoke.CHAIN_DBLS == 252
    ms, by = chip_smoke.bound_ms(1e12, 1.0)
    assert by == "operations" and ms == pytest.approx(1e15 / (132 * 64 * 1.98e9))
    # quorum kernels: __popc at 16 a clock per SM (compute capability 9.0)
    assert chip_smoke.POPC_PER_S == 132 * 16 * 1.98e9
    assert chip_smoke.bound_from(1e-6, 3.35e12) == (1000.0, "bytes")
    assert chip_smoke.bound_from(2.0, 3.35e12) == (2000.0, "operations")


def test_windows_kernel_counts():
    """K-W's bound: K-G's multiply-adds a signature; 637 bytes a signature
    (127 int32 windows, 96 key bytes and R read, the verdict written) and
    the count's 4."""
    assert chip_smoke.kw_bytes(8192) == 8192 * 637 + 4
    ms, by = chip_smoke.bound_ms(8192 * chip_smoke.kg_imads(),
                                 chip_smoke.kw_bytes(8192))
    assert by == "operations" and ms == pytest.approx(0.1393, abs=5e-5)
    assert chip_smoke.KERNEL_WRAPPERS["K-W"] is ed25519.verify_windows


QUAD_OK = {"stack": 16, "spill_stores": 0, "spill_loads": 0,
           "registers": 200}


def _ptxas_of_the_quad_kernels():
    """A clean ptxas summary of K-G, K-W, K-T and K-B (mangled names), and
    of a kernel the check does not cover."""
    return {"_Z21verify_generic_kernelPKhS0_": dict(QUAD_OK),
            "_Z21verify_windows_kernelPKi": dict(QUAD_OK),
            "_Z20verify_tables_kernelPKhS0_": dict(QUAD_OK),
            "_Z19build_tables_kernelPKhPKi": dict(QUAD_OK),
            "_Z15fe_check_kernelPKhS0_": {**QUAD_OK, "stack": 4096}}


@pytest.mark.parametrize("change,ok", [
    ({}, True), ({"stack": 2559}, True), ({"stack": 2560}, False),
    ({"spill_stores": 4}, False), ({"spill_loads": 4}, False),
    (None, False)], ids=["clean", "small-stack", "table-on-stack",
                         "spill-stores", "spill-loads", "missing"])
def test_build_check_of_the_quad_kernels(change, ok):
    """The build phase fails unless ptxas shows K-G and K-W with no spills
    and no stack frame that could hold a 2,560-byte table."""
    ptxas = _ptxas_of_the_quad_kernels()
    if change is None:
        del ptxas["_Z21verify_windows_kernelPKi"]
    else:
        ptxas["_Z21verify_windows_kernelPKi"].update(change)
    if ok:
        chip_smoke.check_quad_kernels(ptxas)
    else:
        with pytest.raises(AssertionError, match="K-G / K-W"):
            chip_smoke.check_quad_kernels(ptxas)


@pytest.mark.parametrize("kernel", ["_Z20verify_tables_kernelPKhS0_",
                                    "_Z19build_tables_kernelPKhPKi"],
                         ids=["K-T", "K-B"])
@pytest.mark.parametrize("change,ok", [
    ({"stack": 159}, True), ({"stack": 160}, False),
    ({"spill_stores": 4}, False), ({"spill_loads": 4}, False),
    (None, False)], ids=["small-stack", "point-on-stack", "spill-stores",
                         "spill-loads", "missing"])
def test_build_check_of_the_table_kernels(kernel, change, ok):
    """K-T and K-B must show no spills and no stack frame that could hold
    a point's 160 bytes of limbs."""
    ptxas = _ptxas_of_the_quad_kernels()
    if change is None:
        del ptxas[kernel]
    else:
        ptxas[kernel].update(change)
    if ok:
        chip_smoke.check_quad_kernels(ptxas)
    else:
        with pytest.raises(AssertionError, match="K-T / K-B"):
            chip_smoke.check_quad_kernels(ptxas)


def test_quorum_constants_are_the_jax_packages():
    """The split of org_qmap(7, 3, 3, 2) and asym5's max_quorums_found, as
    the script fixes them, against the JAX package's checker (asym7's
    in test_asym7_constants_are_the_jax_packages)."""
    pytest.importorskip("jax")
    from stellar_core_tpu.accel.quorum import check_intersection_tpu
    from stellar_core_tpu.testutils import asym_org_qmap
    from stellar_core_tpu.xdr import scp as SX
    from stellar_core_tpu.xdr import types as XT
    from stellar_core_tpu_torch.testutils import nid

    def qset(threshold, validators=(), inner=()):
        return SX.SCPQuorumSet(threshold=threshold,
                               validators=[XT.node_id(v) for v in validators],
                               innerSets=list(inner))

    n_orgs, size, top, inner = chip_smoke.SPLIT_MAP
    orgs = [[nid(100 * o + i) for i in range(size)] for o in range(n_orgs)]
    qmap = {v: qset(top, inner=[qset(inner, org) for org in orgs])
            for org in orgs for v in org}
    res = check_intersection_tpu(qmap)
    assert not res.intersects
    assert res.split == tuple([nid(i) for i in side]
                              for side in chip_smoke.SPLIT_SIDES)
    assert res.max_quorums_found == chip_smoke.SPLIT_MAX_QUORUMS
    assert check_intersection_tpu(asym_org_qmap(5)).max_quorums_found == \
        chip_smoke.ASYM5_MAX_QUORUMS


def _ref_check(qmap, buckets=None):
    """The JAX package's checker on a port map (its own XDR types, node
    ids byte for byte): (result, frontier peak)."""
    from stellar_core_tpu.accel.quorum import TPUQuorumIntersectionChecker
    from stellar_core_tpu.xdr import scp as SX
    from stellar_core_tpu.xdr import types as XT

    def conv(q):
        return SX.SCPQuorumSet(
            threshold=q.threshold,
            validators=[XT.node_id(v.value) for v in q.validators],
            innerSets=[conv(i) for i in q.innerSets])

    ck = TPUQuorumIntersectionChecker({k: conv(v) for k, v in qmap.items()})
    if buckets is not None:
        ck.CAPACITY_BUCKETS = buckets
    return ck.check(), ck._frontier_peak


def test_ladder_and_wide_constants_are_the_jax_packages():
    """asym5's frontier peak on buckets (8, 16), and the 257-node maps'
    results (main-quorum-wide), as the script fixes them, against the JAX
    package's checker."""
    pytest.importorskip("jax")
    from stellar_core_tpu_torch import testutils as qmaps
    res, peak = _ref_check(qmaps.asym_org_qmap(5), (8, 16))
    assert (res.max_quorums_found, peak) == (
        chip_smoke.ASYM5_MAX_QUORUMS, chip_smoke.LADDER_FRONTIER_PEAK)
    res, peak = _ref_check(qmaps.watched_org_qmap(*chip_smoke.WIDE_MAP))
    assert res.intersects and res.node_count == 257
    assert (res.max_quorums_found, peak) == (
        chip_smoke.WIDE_MAX_QUORUMS, chip_smoke.WIDE_FRONTIER_PEAK)
    res, _ = _ref_check(qmaps.watched_org_qmap(*chip_smoke.WIDE_SPLIT_MAP))
    assert not res.intersects
    assert res.split == tuple([qmaps.nid(i) for i in side]
                              for side in chip_smoke.WIDE_SPLIT_SIDES)
    assert res.max_quorums_found == chip_smoke.WIDE_SPLIT_MAX_QUORUMS


def test_asym7_constants_are_the_jax_packages():
    """asym7's max_quorums_found and frontier peak, which main-quorum holds
    the port to on the card, from the JAX package's checker on its CPU
    backend (about 30 s, 1.3 GB)."""
    pytest.importorskip("jax")
    from stellar_core_tpu_torch import testutils as qmaps
    res, peak = _ref_check(qmaps.asym_org_qmap(7))
    assert res.intersects
    assert (res.max_quorums_found, peak) == (
        chip_smoke.ASYM7_MAX_QUORUMS, chip_smoke.ASYM7_FRONTIER_PEAK)


class _Event:
    def __init__(self, at):
        self.at = at

    def elapsed_time(self, end):
        return end.at - self.at


def test_drive_counts_one_calls_launches_and_kernel_time():
    """drive() zeroes the counts before the call, reads them after, sums
    the device time of the launches the call recorded, and turns the event
    recording off again; report() divides it by the call's wall time."""
    tables.verify_tables.launches = 7

    def call():
        tables.verify_tables.launches += 2
        _cuda_build.launch_events.append(("K-T", _Event(1.0), _Event(1.5)))
        _cuda_build.launch_events.append(("K-T", _Event(2.0), _Event(2.25)))
        return np.ones(3, dtype=bool)

    run = chip_smoke.drive(call)
    assert _cuda_build.launch_events is None
    assert run["launches"] == {"K-B": 0, "K-T": 2, "K-G": 0, "K-QF": 0,
                               "K-QC": 0, "K-W": 0}
    assert run["kernel_ms"] == 0.75 and run["verdicts"].all()
    rep = chip_smoke.report(run)
    assert rep["busy_share"] == pytest.approx(0.75 / (1e3 * run["seconds"]))
    # a CPU call launches nothing and records nothing
    run = chip_smoke.drive(lambda: ed25519.verify_batch(
        [b"\x00" * 32], [b"\x00" * 64], [b""], device="cpu"))
    assert run["kernel_ms"] == 0 and set(run["launches"].values()) == {0}


def test_union_counts_overlapping_launches_once():
    """Launches on two streams that overlap count once in busy_ms."""
    assert chip_smoke.union_ms([]) == 0.0
    assert chip_smoke.union_ms([(0.0, 2.0), (1.0, 3.0)]) == 3.0
    assert chip_smoke.union_ms([(4.0, 5.0), (0.0, 5.0), (1.0, 2.0)]) == 5.0
    assert chip_smoke.union_ms(iter([(2.0, 3.0), (0.0, 1.0)])) == 2.0
    rep = chip_smoke.call_report({"seconds": 0.5, "launches": {},
                                  "kernel_ms": 4.0, "busy_ms": 3.0})
    assert rep["busy_share"] == 0.008 and rep["busy_union_share"] == 0.006


def test_main_without_cuda_exits_2_and_prints_nothing(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 2
    assert capsys.readouterr().out == ""


def test_alone_in_a_directory_it_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_widest_segment_is_the_checkers(monkeypatch):
    """record_segments, stopped at the frontier peak, returns the one-depth
    segment the checker launches there, into twice the peak's rows past
    the top bucket (asym5 on buckets (8, 16), whose peak depth the JAX
    package runs host-chunked), as quorum-kernels-vs-plain takes asym7's
    widest depth; quorum_kernel_times.py finds the same depth."""
    import quorum_kernel_times
    from stellar_core_tpu_torch import testutils as qmaps
    from stellar_core_tpu_torch.accel import quorum
    monkeypatch.setattr(quorum.CudaQuorumIntersectionChecker,
                        "CAPACITY_BUCKETS", (8, 16))
    peak, qmap = chip_smoke.LADDER_FRONTIER_PEAK, qmaps.asym_org_qmap(5)
    segs = chip_smoke.record_segments(qmap, "cpu",
                                      lambda a, cap: a[1] == peak)
    (fr, count, bits, rems, active, *_), cap = segs[-1]
    assert (count, cap) == (peak, 2 * peak)
    assert max(a[1] for a, _ in segs) == peak
    assert list(active) == [True] + [False] * (quorum.SEG_DEPTHS - 1)
    # the script runs on the default card; here the CPU stands in
    monkeypatch.setattr(quorum, "resolve", lambda device: torch.device("cpu"))
    _, fr2, bit, rem = quorum_kernel_times.widest_depth(quorum, qmap, peak)
    assert torch.equal(fr2, fr[:count])
    assert torch.equal(bit, bits[0]) and torch.equal(rem, rems[0])


# -- the signature-seam phase --------------------------------------------------

def test_seam_envelopes_hash_as_the_reference_frames_do(libsodium):
    """Each envelope decodes with the JAX package's XDR to the same bytes,
    and the port's hash of its signature payload is the reference's
    TransactionFrame.content_hash; every signature pairs with the source
    account's signer whose hint it carries, and the fixed verdicts are
    libsodium's."""
    from stellar_core_tpu import xdr as RX
    from stellar_core_tpu.testutils import network_id
    from stellar_core_tpu.transactions.frame import TransactionFrame
    envelopes, accounts, fixed = chip_smoke.seam_envelopes(n_ledgers=3)
    decoded, pairs = chip_smoke.seam_decode(envelopes, accounts)
    assert len(envelopes) == 3 * chip_smoke.SEAM_TXS_PER_LEDGER == len(decoded)
    nid = network_id(chip_smoke.SEAM_PASSPHRASE)
    at = 0
    for raw, (h, dsigs, source) in zip(envelopes, decoded):
        env = RX.TransactionEnvelope.from_xdr(raw)
        assert env.to_xdr() == raw
        assert TransactionFrame(nid, env).content_hash() == h
        signers, weight = accounts[source]
        assert weight == len(signers) == len(dsigs)
        for d in dsigs:
            pk, sig, msg = pairs[at]
            assert (sig, msg) == (d.signature, h) and pk[28:32] == d.hint
            assert pk in {s.key.value for s in signers}
            assert sodium.verify_detached(sig, msg, pk) == fixed[at]
            at += 1
    assert at == len(fixed) and fixed.count(False) == len(fixed) // 100


def test_seam_phase_on_the_cpu(libsodium):
    """Both paths of the phase at two ledgers, on the plain versions: every
    envelope's result is the oracle's, every check hits the cache, none is
    recomputed, and the verifier counts every signature."""
    rep = chip_smoke.signature_seam(n_ledgers=2, device="cpu")
    n = rep["signatures"]
    assert rep["envelopes"] == 80 and n > 80 and rep["oracle"] == "libsodium"
    for name, _ in chip_smoke.SEAM_PATHS:
        path = rep[name]
        c = path["counters"]
        assert path["envelope_mismatches"] == 0
        assert c["crypto.verify.cache-hit"] == n and c["crypto.verify.recompute"] == 0
        assert c["accel.ed25519.table-sigs"] + c["accel.ed25519.generic-sigs"] \
            + c["accel.ed25519.rejected-prep"] == n
        assert path["accepted_envelopes"] == 80 - rep["corrupted"]
    assert rep["K-G"]["counters"]["accel.ed25519.generic-sigs"] == n
    assert rep["K-B+K-T"]["counters"]["accel.ed25519.table-sigs"] > 0


def test_seam_checks_fail_on_a_recompute(libsodium, monkeypatch):
    """A verdict left out of the cache is recomputed on the host, and the
    phase refuses the run."""
    envelopes, accounts, fixed = chip_smoke.seam_envelopes(n_ledgers=1)
    decoded, pairs = chip_smoke.seam_decode(envelopes, accounts)
    seed = chip_smoke.crypto_keys.seed_verify_cache
    monkeypatch.setattr(chip_smoke.crypto_keys, "seed_verify_cache",
                        lambda entries: seed(list(entries)[1:]))
    with pytest.raises(AssertionError, match="seam checks failed"):
        chip_smoke.seam_path(decoded, pairs, accounts, fixed, 1 << 62, "cpu")


def test_seam_without_libsodium_tiles_its_envelopes(monkeypatch):
    """Where libsodium is missing, the pure-Python signer signs the first
    n_distinct envelopes and they are tiled; the corrupted signatures
    still follow the signature order, and the phase passes on the fixed
    verdicts."""
    monkeypatch.setattr(chip_smoke.sodium, "_lib", None)
    assert chip_smoke.signer_name() == "python-rfc8032"
    envelopes, accounts, fixed = chip_smoke.seam_envelopes(
        n_ledgers=3, n_distinct=10)
    decoded, pairs = chip_smoke.seam_decode(envelopes, accounts)
    assert len(set(h for h, _, _ in decoded)) == 10
    assert [i for i, ok in enumerate(fixed) if not ok] == \
        list(range(99, len(fixed), 100))
    monkeypatch.setattr(chip_smoke, "seam_envelopes",
                        lambda n: (envelopes, accounts, fixed))
    rep = chip_smoke.signature_seam(n_ledgers=3, device="cpu")
    assert rep["oracle"] == "fixed verdicts"
    assert rep["K-G"]["envelope_mismatches"] == 0


# -- the ledger-apply phase ----------------------------------------------------

# a small chain: 12 accounts (3 co-signed), 20 payment ledgers of 5
# payments (128 signatures, one corrupted), groups of 8 ledgers
APPLY_SMALL = dict(n_payment_ledgers=20, n_accounts=12, txs_per_ledger=5,
                   group=8)


@pytest.fixture(scope="module")
def small_archive():
    args = dict(APPLY_SMALL)
    return chip_smoke.apply_archive(args.pop("n_payment_ledgers"), **args)


def test_apply_archive_is_the_references_chain(small_archive):
    """The oracle chain's envelopes, closed by the JAX package's
    LedgerManager at the same close times, give the same ledger hashes and
    result sets; the corrupted signature's transaction fails; the chain
    ends on a group boundary."""
    from stellar_core_tpu import xdr as RX
    from stellar_core_tpu.ledger.manager import LedgerManager
    from stellar_core_tpu.transactions.frame import TransactionFrame
    from stellar_core_tpu.crypto.sha import sha256
    a = small_archive
    assert a["corrupted"] == 1 and len(a["fixed"]) == 128
    assert a["codes"]["txBAD_AUTH"] >= 1
    mgr = LedgerManager(a["nid"], invariant_manager=None)
    mgr.start_new_ledger()
    assert mgr.lcl_hash == a["genesis"]
    for led in a["ledgers"]:
        frames = [TransactionFrame.make_from_wire(
            a["nid"], RX.TransactionEnvelope.from_xdr(raw))
            for raw in led["envelopes"]]
        arts = mgr.close_ledger(frames, led["close_time"])
        assert mgr.lcl_hash == led["hash"]
        assert sha256(arts.result_entry.txResultSet.to_xdr()) \
            == led["results_hash"]
    assert (a["ledgers"][-1]["seq"] + 1) % APPLY_SMALL["group"] == 0
    assert len(a["ledgers"]) == 1 + 1 + APPLY_SMALL["n_payment_ledgers"]


def test_apply_pairs_is_the_engines_pairing(small_archive):
    """The phase's copy of PreverifyPipeline's pairing gives, group by
    group, the pairs the native engine's extract_pairs gives (which keeps
    the same contract), and every signature of the chain is paired."""
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.ledger import native_apply
    from stellar_core_tpu_torch.ledger.manager import LedgerManager
    from stellar_core_tpu_torch.transactions.frame import TransactionFrame
    if not native_apply.native_apply_available():
        pytest.skip("the native engine did not build or libsodium does "
                    "not load")
    a = small_archive
    mgr = LedgerManager(a["nid"], invariant_manager=None)
    mgr.start_new_ledger()
    assert mgr.attach_native_close()
    bridge = mgr.native_closer.bridge
    harvested, n_pairs = {}, 0
    groups = {}
    for led in a["ledgers"]:
        groups.setdefault(led["seq"] // APPLY_SMALL["group"], []).append(led)
    for leds in groups.values():
        frames = [[TransactionFrame.make_from_wire(
            a["nid"], X.TransactionEnvelope.from_xdr(raw))
            for raw in led["envelopes"]] for led in leds]
        recs = [X.TransactionHistoryEntry(
            ledgerSeq=led["seq"], txSet=X.TransactionSet(
                previousLedgerHash=bytes(32),
                txs=[f.envelope for f in fl])).to_xdr()
            for led, fl in zip(leds, frames)]
        ours = chip_smoke.apply_pairs([f for fl in frames for f in fl],
                                      mgr.root, harvested)
        engine = bridge.extract_pairs(recs)
        assert sorted(zip(*ours[:3])) == sorted(zip(*engine[:3]))
        assert ours[3] == engine[3]
        n_pairs += len(ours[0])
        for led, fl in zip(leds, frames):
            mgr.close_ledger(fl, led["close_time"])
            assert mgr.lcl_hash == led["hash"]
    assert n_pairs == len(a["fixed"])


def test_apply_phase_on_the_cpu(libsodium):
    """The phase at a small size on the plain versions: the Python close on
    K-G's and K-B + K-T's verdicts and the native close give the oracle's
    hash at every ledger and the oracle's result codes, every check hits
    the cache, none is recomputed, the verifier counts every pair."""
    rep = chip_smoke.ledger_apply(device="cpu", **APPLY_SMALL)
    assert rep["phase"] == "ledger-apply" and rep["corrupted"] == 1
    for name, _ in chip_smoke.APPLY_PATHS:
        run = rep[name]
        c = run["counters"]
        assert run["final_hash"] == rep["final_hash"]
        assert run["codes"] == rep["codes"]
        assert run["pairs"] == run["signatures"] == rep["signatures"]
        assert c["crypto.verify.recompute"] == 0
        assert c["crypto.verify.cache-hit"] == run["ed25519_checks"] > 0
        assert set(run["steps_s"]) == {"pair", "verify", "seed", "close"}
        assert run["launches"]["K-G"] == 0      # the CPU runs plain
    assert rep["K-G"]["counters"]["accel.ed25519.generic-sigs"] == 128
    assert rep["K-B+K-T"]["counters"]["accel.ed25519.table-sigs"] > 0
    native = rep["native"]
    if rep["libsodium"] and rep["capply"]:
        assert native["final_hash"] == rep["final_hash"]
        assert native["engine_stats"]["verify_cache_misses"] == 0
    else:
        assert native["ran"] is False


def test_apply_replay_refuses_a_ledger_that_is_not_the_oracles(
        small_archive):
    a = dict(small_archive)
    a["ledgers"] = [dict(led) for led in a["ledgers"]]
    a["ledgers"][5]["hash"] = bytes(32)
    with pytest.raises(RuntimeError, match="hash"):
        chip_smoke.apply_replay(a, 1 << 62, device="cpu",
                                group=APPLY_SMALL["group"])


def test_apply_replay_refuses_a_recompute(small_archive, monkeypatch):
    """A verdict left out of the cache is recomputed on the host, and the
    run is refused."""
    seed = chip_smoke.crypto_keys.seed_verify_cache
    monkeypatch.setattr(chip_smoke.crypto_keys, "seed_verify_cache",
                        lambda entries: seed(list(entries)[1:]))
    with pytest.raises(AssertionError, match="recomputed"):
        chip_smoke.apply_replay(small_archive, 1 << 62, device="cpu",
                                group=APPLY_SMALL["group"])


def test_apply_phase_without_libsodium_runs_no_native_close(
        small_archive, monkeypatch):
    """Where libsodium does not load, native close refuses to attach and
    the phase says so instead of running the engine."""
    from stellar_core_tpu_torch.ledger import native_apply
    monkeypatch.setattr(native_apply, "libsodium_loads", lambda: False)
    monkeypatch.setattr(chip_smoke, "apply_archive",
                        lambda *args: small_archive)
    ran = []

    def replay(archive, hot, native=False, device=None, group=64):
        ran.append((hot, native))
        return {"launches": dict.fromkeys(chip_smoke.KERNEL_WRAPPERS, 0),
                "counters": {"accel.ed25519.generic-sigs": 0}}

    monkeypatch.setattr(chip_smoke, "apply_replay", replay)
    rep = chip_smoke.ledger_apply(device="cpu", **APPLY_SMALL)
    assert ran == [(1 << 62, False), (4, False)]
    assert rep["native"]["ran"] is False
    assert "libsodium" in rep["native"]["why"] or not rep["capply"]


# a chain of three checkpoints for the catchup phase: 12 accounts, 130
# payment ledgers of 2 payments, published as the oracle closes it
CATCHUP_SMALL = dict(n_payment_ledgers=130, n_accounts=12, txs_per_ledger=2,
                     group=64)


@pytest.fixture(scope="module")
def published_small(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("chip-smoke-archive"))
    args = dict(CATCHUP_SMALL)
    return chip_smoke.apply_archive(args.pop("n_payment_ledgers"), **args,
                                    archive_dir=path), path


def test_catchup_phase_on_the_cpu(published_small, monkeypatch):
    """The phase at a small size on the plain versions: the archive the
    oracle published ends on its last ledger, and runs (a)-(c) through
    CatchupManager and (d) through the command line with three range
    workers all end on its hash, with every counter printed."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    archive, path = published_small
    assert archive["published"] == [63, 127, 191]
    rep = chip_smoke.catchup_phase(archive, path, device="cpu")
    last = archive["ledgers"][-1]
    assert (rep["archive_ledgers"], rep["archive_hash"]) \
        == (191, last["hash"].hex())
    for name, _, _ in chip_smoke.CATCHUP_RUNS:
        run = rep[name]
        assert run["final_hash"] == last["hash"].hex() and run["ledgers"] == 190
        assert run["stats"]["sigs_total"] == len(archive["fixed"])
        assert set(run) >= {"offload_hit_rate", "fallback_verify_s",
                            "kernel_ms_upper", "kernel_share_upper",
                            "launches"}
        assert run["launches"]["K-G"] == 0      # the CPU runs plain
    assert rep["a"]["counters"]["accel.ed25519.generic-sigs"] > 0
    assert rep["b"]["counters"]["accel.ed25519.table-sigs"] > 0
    # race: each group either shipped or lost its bounded wait
    c = rep["c"]["stats"]
    assert c["sigs_shipped"] + c["sigs_race_lost"] == c["sigs_total"]
    d = rep["d"]
    assert d["final_hash"] == last["hash"].hex()
    assert d["stitches_verified"] == 2 and len(d["ranges"]) == 3
    assert all(r["launches"] == {"K-G": 0, "K-B": 0, "K-T": 0}
               for r in d["ranges"])


def test_catchup_run_refuses_a_hash_that_is_not_the_tip(published_small):
    archive, path = published_small
    tip = chip_smoke.archive_tip(path)
    with pytest.raises(AssertionError, match="not the archive's tip"):
        chip_smoke.catchup_run(path, archive["nid"], (tip[0], bytes(32)),
                               {}, device="cpu")


@pytest.mark.parametrize("what, launches, generic, ok", [
    ("K-G", {"K-G": 35, "K-B": 0, "K-T": 0}, 55020, True),
    ("K-G", {"K-G": 35, "K-B": 1, "K-T": 0}, 55020, False),
    ("K-G", {"K-G": 0, "K-B": 0, "K-T": 0}, 0, False),
    ("K-B+K-T", {"K-G": 1, "K-B": 5, "K-T": 35}, 3, True),
    ("K-B+K-T", {"K-G": 0, "K-B": 5, "K-T": 35}, 0, True),
    ("K-B+K-T", {"K-G": 0, "K-B": 5, "K-T": 35}, 3, False),
    ("K-B+K-T", {"K-G": 1, "K-B": 0, "K-T": 35}, 3, False),
])
def test_a_path_must_run_on_its_kernels(what, launches, generic, ok):
    counters = {"accel.ed25519.generic-sigs": generic}
    if ok:
        chip_smoke.check_path_kernels(what, launches, counters)
    else:
        with pytest.raises(AssertionError, match="launches"):
            chip_smoke.check_path_kernels(what, launches, counters)


# -- admission and consensus --------------------------------------------------

# the phases at a small size: the campaign's pipeline dispatches batches of
# at least 4 signatures (its default, 64, exceeds these batches)
ADMISSION_SMALL = dict(
    knobs={"n_accounts": 64, "batch_size": 16, "max_tx_set_ops": 50,
           "max_backlog": 200},
    runs=((3, 40),), sustained_accounts=300,
    sustained_runs=((2, 30), (2, 60)), sustained_cap=30,
    sustained_backlog=100, accel_min_sigs=4)
CONSENSUS_SMALL = dict(n_accounts=40, n_ledgers=3, burst=30, batch_size=8,
                       accel_min_sigs=4, accel_chunk=256)


@pytest.fixture
def plain_admission(monkeypatch):
    """The preverify pipeline on the plain versions, with a race budget
    that the plain K-G on the CPU (far slower than the card) never
    misses."""
    from stellar_core_tpu_torch.catchup.catchup import PreverifyPipeline
    monkeypatch.setattr(PreverifyPipeline, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setattr(PreverifyPipeline, "RACE_CPU_S_PER_SIG", 10.0)
    return PreverifyPipeline


def test_admission_phase_on_the_cpu(plain_admission):
    """(a) equals its accel-off oracle and (b) keeps the bench's bounds,
    both with every batch after warmup dispatched and none lost."""
    rep = chip_smoke.admission_phase(device="cpu", **ADMISSION_SMALL)
    a, b = rep["a"], rep["b"]
    assert a["equals_oracle"] and a["ledgers"] == 3
    assert a["statuses"] == {"pending": 120}
    assert a["stats"]["sigs_offloaded"] > 0
    assert a["oracle_stats"]["sigs_offloaded"] == 0
    assert a["batch_checks"]["eligible_not_dispatched"] == 0
    assert a["launches"]["K-G"] == 0            # the CPU runs plain
    assert b["ledgers"] == 4
    assert b["overload"]["peak_queue_depth"] <= 4 * 30
    assert b["overload"]["peak_admission_depth"] <= 100
    assert b["stats"]["sigs_offloaded"] > 0
    assert set(b) >= {"shed", "prefiltered", "collect_wait_s", "install_s",
                      "sustained", "overload"}
    json.dumps(rep)


def test_consensus_phase_on_the_cpu(plain_admission):
    """The validator's ledgers equal its accel-off oracle's, every admitted
    transaction applied, batches on the plain K-G."""
    rep = chip_smoke.consensus_phase(device="cpu", **CONSENSUS_SMALL)
    assert rep["equals_oracle"] and rep["ledgers"] == 3
    assert rep["applied"] == 90 and rep["statuses"] == {"pending": 90}
    assert rep["transitions"] == [("booting", "tracking", "bootstrap")]
    assert rep["stats"]["sigs_offloaded"] == 90 - 3   # all but the sync path
    assert rep["host"]["cpu_verifies"] == 3
    assert rep["oracle_host"]["cpu_verifies"] == 90
    assert len(rep["externalize_s"]) == 3
    json.dumps(rep)


def test_consensus_oracle_comparison_sees_a_different_ledger(
        plain_admission, monkeypatch):
    """A card run that closes one ledger differently fails the phase."""
    real = chip_smoke.consensus_run

    def run(accel, device=None, **kw):
        out = real(accel, device, **kw)
        if accel:
            out["ledgers"][1]["hash"] = "00" * 32
        return out

    monkeypatch.setattr(chip_smoke, "consensus_run", run)
    with pytest.raises(AssertionError, match="accel-off oracle"):
        chip_smoke.consensus_phase(device="cpu", **CONSENSUS_SMALL)


@pytest.fixture
def device_gate(monkeypatch, plain_admission):
    """Installs a stand-in for the device job's gate; a gate that blocks
    is released when the test ends, and the device workers it parked are
    joined (a closed pipeline does not wait on its worker, which would
    otherwise go on verifying the parked batches on the plain versions
    while the next test runs)."""
    import threading
    release = threading.Event()

    def install(gate):
        monkeypatch.setattr(plain_admission, "DEVICE_GATE",
                            staticmethod(lambda i: gate(i, release)))

    yield install
    release.set()
    chip_smoke.join_device_workers(120.0)


def never_warms(i, release):
    if i == 0:                          # the warm batch
        release.wait(60)


def loses_races(i, release):
    """A barrier, not a sleep: every batch after the warm one blocks until
    the test ends, so each of their collects misses its race budget
    however late it comes."""
    if i >= 1:
        release.wait()


@pytest.mark.parametrize("phase", ["admission", "consensus"])
@pytest.mark.parametrize("gate, match", [
    (never_warms, "never warmed"), (loses_races, "races lost")],
    ids=["never-warms", "loses-races"])
def test_a_phase_fails_when_the_card_is_not_used(
        phase, gate, match, device_gate, plain_admission, monkeypatch):
    """A stand-in device job that never delivers the warm batch, or that
    loses the race of every batch, fails the phase: its results are the
    oracle's all the same (verified on the CPU), which is why the card's
    use is checked apart."""
    device_gate(gate)
    if gate is never_warms:
        monkeypatch.setattr(chip_smoke, "WARM_TIMEOUT_S", 2.0)
    else:                               # the pipeline's own budget; the
        # warm batch, which the barrier lets through, keeps the phase's
        # own WARM_TIMEOUT_S however loaded the machine is
        monkeypatch.setattr(plain_admission, "RACE_CPU_S_PER_SIG", 40e-6)
    with pytest.raises(AssertionError, match=match):
        if phase == "admission":
            chip_smoke.admission_phase(device="cpu", **ADMISSION_SMALL)
        else:
            chip_smoke.consensus_phase(device="cpu", **CONSENSUS_SMALL)


class _Pipe:
    """What check_card_use reads of an AdmissionPipeline."""

    def __init__(self, warmed, stats, device="cuda"):
        self._warmed = warmed
        self.accel_min_sigs = 64
        self.stats = stats
        self._preverify = types.SimpleNamespace(
            devices=(torch.device(device),))


class _Log:
    def __init__(self, batches):
        self.batches = batches


GOOD_STATS = {"sigs_offloaded": 512, "race_losses": 0, "collect_fallbacks": 0}


@pytest.mark.parametrize("warmed, batches, stats, launches, match", [
    (True, [(256, False, False), (256, True, True), (10, True, False)],
     GOOD_STATS, {"K-G": 2}, None),
    (False, [(256, False, False)], {**GOOD_STATS, "sigs_offloaded": 0},
     {"K-G": 1}, "never warmed"),
    (True, [(256, True, True), (256, True, False)], GOOD_STATS, {"K-G": 1},
     "1 batches of >= 64"),
    (True, [(256, True, True)], GOOD_STATS, {"K-G": 0}, "K-G never"),
    (True, [(256, True, True)], {**GOOD_STATS, "collect_fallbacks": 1},
     {"K-G": 1}, "fell back"),
    (True, [(32, True, False)], {**GOOD_STATS, "sigs_offloaded": 0},
     {"K-G": 1}, "no signature was offloaded"),
])
def test_card_use_checks(warmed, batches, stats, launches, match):
    pipe, log = _Pipe(warmed, stats), _Log(batches)
    if match is None:
        counts = chip_smoke.check_card_use("run", pipe, log, launches)
        assert counts["eligible_batches"] == 1
        assert counts["batches_before_warm"] == 1
        assert counts["batches_below_min"] == 1
    else:
        with pytest.raises(AssertionError, match=match):
            chip_smoke.check_card_use("run", pipe, log, launches)


# -- node and network ----------------------------------------------------------

NODE_SMALL = dict(n_accounts=40, burst=30, batch_size=8, accel_min_sigs=4,
                  chunk=256, timeout=120.0)
NETWORK_SMALL = dict(n_accounts=40, n_ledgers=3, burst=30, batch_size=8,
                     accel_min_sigs=4, accel_chunk=256)


def test_node_phase_on_the_cpu(plain_admission):
    """A node served by `run` with ACCEL "cpu": every /tx answer accepted,
    every accepted payment applied, two checkpoints published and the
    archive's replay on the node's hash; batches on the plain K-G."""
    from stellar_core_tpu_torch.history.archive import checkpoint_frequency
    cadence = checkpoint_frequency()
    handler = signal.getsignal(signal.SIGTERM)
    rep = chip_smoke.node_phase(device="cpu", **NODE_SMALL)
    assert rep["statuses"] == {"PENDING": 30} and rep["applied"] == 30
    assert len(rep["checkpoints"]) >= 2
    assert rep["replayed_to"] == rep["checkpoints"][-1]
    assert rep["stats"]["sigs_offloaded"] > 0
    assert rep["batch_checks"]["eligible_not_dispatched"] == 0
    assert rep["launches"]["K-G"] == 0            # the CPU runs plain
    assert rep["x25519"] == "libsodium"
    # run's signal handlers and the node's checkpoint cadence are undone
    assert signal.getsignal(signal.SIGTERM) is handler
    assert checkpoint_frequency() == cadence
    json.dumps(rep)


def test_a_node_whose_batches_never_reach_the_device_fails(plain_admission):
    """A node whose every batch is verified on the CPU (none reaches
    accel_min_sigs) serves its clients all the same, and fails the phase."""
    with pytest.raises(AssertionError, match="no signature was offloaded"):
        chip_smoke.node_phase(device="cpu", **{**NODE_SMALL,
                                               "accel_min_sigs": 10 ** 6})


def test_node_phase_refuses_a_replay_off_the_nodes_hash(plain_admission,
                                                       monkeypatch):
    """The archive's CPU replay must end on the node's hash."""
    real = chip_smoke.node_run

    def run(*args, **kw):
        out = real(*args, **kw)
        seq = out["replayed"][0]
        out["node_hash"][seq] = "00" * 32
        return out

    monkeypatch.setattr(chip_smoke, "node_run", run)
    with pytest.raises(AssertionError, match="CPU replay of its archive"):
        chip_smoke.node_phase(device="cpu", **NODE_SMALL)


def test_node_refuses_cuda_without_a_card(monkeypatch):
    """`run` with ACCEL "cuda" and no card exits 1 before serving."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(AssertionError, match="run exited 1"):
        chip_smoke.node_run(None, n_accounts=4, burst=2, timeout=5.0)


def test_network_phase_on_the_cpu(plain_admission):
    """Three validators over loopback peers: every ledger the same on each
    and the accel-off oracle's, every payment applied, batches on the
    plain K-G."""
    rep = chip_smoke.network_phase(device="cpu", **NETWORK_SMALL)
    assert rep["equals_oracle"] and rep["ledgers"] == 3
    assert rep["applied"] == 30 and rep["statuses"] == {"pending": 30}
    assert all(s["sigs_offloaded"] > 0 for s in rep["stats"])
    assert len(rep["batch_checks"]) == 3
    assert rep["launches"]["K-G"] == 0
    json.dumps(rep)


def test_a_network_node_that_closes_one_ledger_differently_fails(
        plain_admission, monkeypatch):
    real = chip_smoke.network_run

    def run(accel, device=None, **kw):
        out = real(accel, device, **kw)
        if accel:
            out["closes"][1][1]["hash"] = "00" * 32
        return out

    monkeypatch.setattr(chip_smoke, "network_run", run)
    with pytest.raises(AssertionError, match="validator 1 closed "
                                             "differently"):
        chip_smoke.network_phase(device="cpu", **NETWORK_SMALL)


def test_network_oracle_comparison_sees_a_different_ledger(
        plain_admission, monkeypatch):
    real = chip_smoke.network_run

    def run(accel, device=None, **kw):
        out = real(accel, device, **kw)
        if accel:
            for mine in out["closes"]:
                mine[0]["tx_set_hash"] = "00" * 32
        return out

    monkeypatch.setattr(chip_smoke, "network_run", run)
    with pytest.raises(AssertionError, match="accel-off oracle"):
        chip_smoke.network_phase(device="cpu", **NETWORK_SMALL)


def test_the_kernels_line_carries_the_live_node_launches():
    def phase(n):
        return {"launches": {"K-G": n}}

    got = chip_smoke.admission_launches(
        {"a": phase(1), "b": phase(2)}, phase(3), phase(4), phase(5),
        {"launches_nodes": 6, "launches_rejoin": 7})
    assert got == {"admission_a": 1, "admission_b": 2, "consensus": 3,
                   "node": 4, "network": 5, "fleet_nodes": 6,
                   "fleet_rejoin": 7}


# -- the fleet and the commands ------------------------------------------------

TIP_SEQ = 23


def _ledger_hash(seq: int) -> str:
    return f"{seq:064x}"


def _canned_run(tmp_path, diverge_at=None):
    """A fleet run that passes fleet_checks on the card: the report of a
    provisioned five-node Fleet's finalize() (no process started), filled
    with what a good run's samples, scrapes and trace give, a rejoin log
    of one range on K-G, each node's stored tip and a CPU replay on its
    hash.  With `diverge_at`, node 4's sample of that ledger is another
    hash."""
    from stellar_core_tpu_torch.simulation.fleet import Fleet
    fleet = Fleet(str(tmp_path), n_nodes=5)
    fleet.provision()
    os.makedirs(os.path.join(fleet.archive_dir, ".well-known"))
    with open(os.path.join(fleet.archive_dir, ".well-known",
                           "stellar-history.json"), "w") as f:
        json.dump({"currentLedger": TIP_SEQ}, f)
    fleet.hash_by_seq = {seq: {n: _ledger_hash(seq) for n in range(5)}
                         for seq in range(2, 30)}
    if diverge_at is not None:
        fleet.hash_by_seq[diverge_at][4] = "ff" * 32
    fleet.metrics.update(retracking_s=12.5, kill_to_retracking_s=21.0,
                         roll_node_s={str(n): 6.0 for n in range(5)})
    fleet.client.offered = 400
    fleet.client.statuses = {"PENDING": 380, "TRY-AGAIN-LATER": 20}
    for node in fleet.nodes:
        node.note_accel({"accel": {
            "pid": 1000 + node.index, "accel": "cuda",
            "devices": ["cuda:0"], "cuda_initialized": True,
            "launches": {"K-G": 1, "K-B": 0, "K-T": 0},
            "admission": {"batches": 40, "dispatch_groups": 1,
                          "sigs_offloaded": 0, "warmed": True}}})
    report = fleet.finalize()
    nodes = [f"node-{n}" for n in range(5)]
    events = [{"ph": "M", "name": "process_name", "args": {"name": n}}
              for n in nodes]
    events += [{"ph": "i", "name": f"{phase}@5"}
               for phase in ("externalize", "close-seal")]
    report["observability"].update(
        trace_events=len(events), trace_nodes=nodes,
        clock_offsets_s={n: 0.0 for n in nodes},
        scraper={"polls": 40,
                 "curves": {"close_p99_s": {"node-0": [[1.0, 0.2],
                                                       [2.0, 0.2]]}},
                 "divergence": {"close_p99_s": 0.0},
                 "slo": {"objectives": {"close-p99": {"evaluations": 9}}}})
    log = ("caught up to ledger 7 hash " + _ledger_hash(7)
           + " (1 ranges, 0 stitches verified, 14.2 ledgers/s)\n"
           'range 0: 6 ledgers to 7 (30.5 ledgers/s), offload hit rate 1.0, '
           'launches {"K-B": 0, "K-G": 1, "K-T": 0}\n'
           "state persisted to node.db\n")
    return {"rc": 0, "report": report, "catchup_log": log,
            "trace_events": events, "stderr_tail": "", "kernels_built": [],
            "stored_tip_hashes": {str(n): _ledger_hash(TIP_SEQ)
                                  for n in range(5)},
            "replay": (TIP_SEQ, _ledger_hash(TIP_SEQ))}


@pytest.fixture
def canned_fleet(tmp_path):
    return _canned_run(tmp_path)


def test_fleet_checks_pass_a_good_run(canned_fleet):
    seen = chip_smoke.fleet_checks(canned_fleet)
    assert [r["launches"]["K-G"] for r in seen["ranges"]] == [1]
    assert [(p["node"], p["K-G"], p["batches_card"], p["batches_cpu"])
            for p in seen["processes"]] == [(n, 1, 0, 40) for n in range(5)]


def _no_kg_range(run):
    run["catchup_log"] = run["catchup_log"].replace('"K-G": 1', '"K-G": 0')


def _warm_batch_on_the_cpu(run):
    rec = run["report"]["node_artifacts"][3]["accel"][0]
    rec.update(devices=["cpu"], cuda_initialized=False,
               launches={"K-G": 0, "K-B": 0, "K-T": 0})


def _replay_off_the_hash(run):
    run["replay"] = (TIP_SEQ, "00" * 32)


def _a_node_built_a_kernel(run):
    run["kernels_built"] = ["verify_generic-0123abcd.so"]


def _a_node_stored_another_tip(run):
    run["stored_tip_hashes"]["1"] = "ee" * 32


def _no_majority_holds_the_tip(run):
    run["stored_tip_hashes"] = {"0": _ledger_hash(TIP_SEQ),
                                "1": _ledger_hash(TIP_SEQ)}


@pytest.mark.parametrize("spoil, match", [
    (_no_kg_range, "rejoin range 0 did not verify on the card"),
    (_warm_batch_on_the_cpu,
     "node 3 process 1003 did not verify its warm batch on the card"),
    (_replay_off_the_hash, "the CPU replay ended on"),
    (_a_node_built_a_kernel, "fleet processes built kernels"),
    (_a_node_stored_another_tip, "the CPU replay ended on"),
    (_no_majority_holds_the_tip, "the CPU replay ended on"),
], ids=["range-without-K-G", "warm-batch-off-the-card",
        "replay-off-the-fleets-hash", "a-process-built-a-kernel",
        "a-node-stored-another-tip",
        "no-majority-reported-the-tip"])
def test_fleet_checks_fail_a_spoiled_run(canned_fleet, spoil, match):
    spoil(canned_fleet)
    with pytest.raises(AssertionError, match=match):
        chip_smoke.fleet_checks(canned_fleet)


def test_fleet_checks_fail_a_hash_divergence(tmp_path):
    """Two nodes that reported two hashes for one ledger fail the fleet's
    own divergence check, its report, and so the phase."""
    run = _canned_run(tmp_path, diverge_at=10)
    assert not run["report"]["passed"]
    with pytest.raises(AssertionError, match="HASH DIVERGENCE at ledger 10"):
        chip_smoke.fleet_checks(run)


def test_fleet_ranges_read_the_printed_lines_only():
    """The orchestrator's log record of a range (timestamped) is not read
    twice; a range without accel has no launches."""
    log = ("2026-01-01 00:00:00,000 [stellar.History INFO] range 0: 6 "
           "ledgers to 7 (1.0 ledgers/s), offload hit rate 0.0, launches "
           "none\nrange 0: 6 ledgers to 7 (1.0 ledgers/s), offload hit "
           "rate 0.0, launches none\n")
    assert chip_smoke.fleet_ranges(log) == [
        {"index": 0, "ledgers": 6, "to": 7, "ledgers_per_s": 1.0,
         "hit_rate": 0.0, "launches": None}]


def test_commands_phase_on_the_cpu(plain_admission, tmp_path):
    """The port's command line over a small node's state: every command
    exits 0 and names the node's last ledger and its archive's replay."""
    node = chip_smoke.node_phase(device="cpu", workdir=str(tmp_path),
                                 **NODE_SMALL)
    rep = chip_smoke.commands_phase(str(tmp_path), node, device="cpu")
    assert rep["last_closed"] == node["last_closed"][0]
    assert rep["replayed_to"] == node["replayed_to"]
    assert rep["dump_ledger_entries"] == 10
    assert all(r["rc"] == 0 for r in rep["commands"].values())
    assert set(rep["commands"]) >= {
        "self-check", "offline-info", "diag-bucket-stats", "dump-ledger",
        "verify-checkpoints", "report-last-history-checkpoint", "publish",
        "new-hist"}
    # the node's state is the commands': another last ledger fails them
    with pytest.raises(AssertionError, match="offline-info names ledger"):
        chip_smoke.commands_phase(
            str(tmp_path), {**node, "last_closed": (1, "00" * 32)},
            device="cpu")


# -- determinism ---------------------------------------------------------------

CLEAN = ("native/cxdr.c: warning-clean\nnative/capply.c: warning-clean\n"
         "native/cquorum.c: warning-clean\n")
ARRAY_PARAM = ("/r/native/capply.c:4860:62: error: argument 4 of type "
               "'const uint8_t[32]' with mismatched bound "
               "[-Werror=array-parameter=]\n"
               "/r/native/capply.c:2883:54: note: previously declared as "
               "'const uint8_t *'\n")
OTHER = "/r/native/capply.c:10:5: error: unused variable 'x' " \
        "[-Werror=unused-variable]\n"


@pytest.mark.parametrize("out, failing, known", [
    (CLEAN, [], False),
    ("native/cxdr.c: warning-clean\nnative/capply.c: FAIL\n" + ARRAY_PARAM
     + "cc1: all warnings being treated as errors\n"
     "native/cquorum.c: warning-clean\n", ["native/capply.c"], True),
    ("native/cxdr.c: warning-clean\nnative/capply.c: FAIL\n" + ARRAY_PARAM
     + OTHER + "native/cquorum.c: warning-clean\n", ["native/capply.c"],
     False),
    ("native/cxdr.c: FAIL\n" + ARRAY_PARAM.replace("capply", "cxdr")
     + "native/capply.c: warning-clean\nnative/cquorum.c: warning-clean\n",
     ["native/cxdr.c"], False),
    ("native/cxdr.c: warning-clean\nnative/capply.c: FAIL (compiler did not "
     "finish: timeout)\nnative/cquorum.c: warning-clean\n",
     ["native/capply.c"], False),
])
def test_warn_check_verdict_knows_only_the_shared_fault(out, failing, known):
    v = chip_smoke.warn_check_verdict(out)
    assert v["failing"] == failing and v["only_known_fault"] is known
    assert set(v["verdicts"]) == {"native/cxdr.c", "native/capply.c",
                                  "native/cquorum.c"}


def fake_cli(lint_rc=0, det_rc=0, warn_rc=0, warn_out=CLEAN):
    def run(argv, timeout=600.0):
        if argv[1] == "stellar_core_tpu_torch._native_build":
            return {"rc": warn_rc, "out": warn_out, "seconds": 0.1}
        rc = det_rc if "--rules" in argv else lint_rc
        return {"rc": rc, "seconds": 0.1,
                "out": "corelint: 154 files, 0 violation(s) [clean]\n"}
    return run


@pytest.mark.parametrize("kw, match", [
    ({}, None),
    ({"warn_rc": 1, "warn_out": "native/capply.c: FAIL\n" + ARRAY_PARAM},
     None),
    ({"lint_rc": 1}, "lint exited 1"),
    ({"det_rc": 1}, "determinism rules exited 1"),
    ({"warn_rc": 1, "warn_out": "native/capply.c: FAIL\n" + OTHER},
     "--warn-check exited 1"),
])
def test_determinism_static_fails_on_any_finding(kw, match):
    if match is None:
        rep = chip_smoke.determinism_static(fake_cli(**kw))
        assert rep["warn_check"]["rc"] == kw.get("warn_rc", 0)
    else:
        with pytest.raises(AssertionError, match=match):
            chip_smoke.determinism_static(fake_cli(**kw))


def child_doc(view):
    return {"view": view, "validators_agree": True, "launches": {"K-G": 12},
            "detguard": {"armed": True, "regions": 40, "trips": 0}}


@pytest.mark.parametrize("spoil, device, match", [
    ({}, None, None),
    ({"launches": {"K-G": 0}}, "cpu", None),
    ({"launches": {"K-G": 0}}, None, "K-G never launched"),
    ({"detguard": {"armed": True, "regions": 40, "trips": 1}}, None,
     "detguard"),
    ({"detguard": {"armed": False, "regions": 0, "trips": 0}}, None,
     "detguard"),
    ({"validators_agree": False}, None, "closed differently"),
    ({"view": [{"seq": 2, "hash": "00" * 32}]}, None, "accel-off run's"),
])
def test_network_children_are_held_to_the_oracle_and_the_guard(
        spoil, device, match):
    want = [{"seq": 2, "hash": "ab" * 32}]
    docs = [(0, child_doc(want)), (424242, {**child_doc(want), **spoil})]
    faults = chip_smoke.network_child_faults(docs, want, device)
    if match is None:
        assert faults == []
    else:
        assert len(faults) == 1 and faults[0].startswith("seed 424242")
        assert match in faults[0]


def test_determinism_phase_on_the_cpu(plain_admission):
    """(a) read from the command lines' answers, (b) a small flagship and
    Soroban campaign, (c) a small network in two processes under the two
    hash seeds with the guard armed, on the accel-off run's ledgers."""
    oracle = chip_smoke._network_view(
        chip_smoke.network_run(False, **NETWORK_SMALL))
    rep = chip_smoke.determinism_phase(
        oracle, device="cpu", differential={"orgs": 3, "ledgers": 3},
        network=NETWORK_SMALL, run_cli=fake_cli())
    assert [c["campaign"] for c in rep["differential"]] \
        == ["flagship", "soroban"]
    for c in rep["differential"]:
        assert c["identical"] and len(c["children"]) == 2
        assert all(g["armed"] and g["regions"] > 0 and g["trips"] == 0
                   for g in c["detguard"])
    net = rep["network"]
    assert [c["hashseed"] for c in net["children"]] == ["0", "424242"]
    assert net["ledgers"] == len(oracle) and net["last_hash"] \
        == oracle[-1]["hash"]
    assert all(c["detguard"]["regions"] > 0 and c["detguard"]["trips"] == 0
               for c in net["children"])
    json.dumps(rep)
