"""What of chip_smoke.py runs without a card: its pure-Python RFC 8032
signer equals libsodium byte for byte, its fixed adversarial verdicts are
libsodium's, its fixed quorum results are the JAX package's, its kernel
operation counts follow the device code, its main-path runs count launches
and kernel time per call, and the script refuses to run (exit 2, no
result) without CUDA and fails in a directory that holds only itself."""

import os
import shutil
import subprocess
import sys
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


def test_python_signer_equals_libsodium(libsodium):
    """The script signs through the port's RFC 8032 signer where libsodium
    is missing (crypto/rfc8032.py, moved there from this script)."""
    assert chip_smoke.Signer is rfc8032.Signer
    for i in range(4):
        seed = bytes([i * 7 + 1]) * 32
        pk, sk = rfc8032.keypair(seed)
        spk, ssk = sodium.sign_seed_keypair(seed)
        assert pk == spk
        for msg in (b"", b"m", bytes(range(120))):
            assert rfc8032.sign(msg, sk) == sodium.sign_detached(msg, ssk)


def test_adversarial_constants_are_libsodiums(libsodium, monkeypatch):
    cases = chip_smoke.adversarial_cases(chip_smoke.Signer())
    for name, triples, expected in cases:
        assert [sodium.verify_detached(s, m, p) for p, s, m in triples] == \
            expected, name
    # the fallback signer makes the very same vectors
    monkeypatch.setattr(chip_smoke.sodium, "available", lambda: False)
    signer = chip_smoke.Signer()
    assert signer.name == "python-rfc8032"
    assert chip_smoke.adversarial_cases(signer) == cases


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
