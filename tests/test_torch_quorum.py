"""The port's quorum-intersection enumerator against the JAX package's.

The same maps (built on each package's own XDR types, node ids byte for
byte equal) go through ``check_intersection_cuda(..., device="cpu")``,
which runs the plain PyTorch versions of kernels K-QF and K-QC, and
through the reference's TPUQuorumIntersectionChecker on JAX's CPU backend.
Verdict, split (node lists, in order), max_quorums_found, node_count,
main_scc_size and the frontier peak must be equal, exactly.  At the
function level the plain prune_step / segment_step are held against the
reference's _prune_step / _segment_step on recorded states of real runs.
Mirrors tests/test_accel_quorum.py (TestDifferential, TestResidentFrontier,
TestBigMap).  Maps stay at asym5 or smaller; each reference run is made
once per module.
"""

import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from stellar_core_tpu import testutils as ref_testutils
from stellar_core_tpu.accel import quorum as RQ
from stellar_core_tpu.herder import quorum_intersection as RH
from stellar_core_tpu.xdr import scp as SX
from stellar_core_tpu.xdr import types as XT

import bench
from stellar_core_tpu_torch import convert
from stellar_core_tpu_torch import testutils as TU
from stellar_core_tpu_torch.accel import quorum as Q
from stellar_core_tpu_torch.herder import quorum_intersection as PH


def to_ref(qmap):
    """A port quorum map as the reference's XDR objects."""
    def conv(q):
        return SX.SCPQuorumSet(
            threshold=q.threshold,
            validators=[XT.node_id(v.value) for v in q.validators],
            innerSets=[conv(i) for i in q.innerSets])
    return {k: conv(v) for k, v in qmap.items()}


def random_qmaps():
    """tests/test_accel_quorum.py's random flat maps, on the port's types."""
    rng = random.Random(42)
    out = []
    for _ in range(12):
        n = rng.randrange(3, 9)
        ids = [TU.nid(i) for i in range(n)]
        qmap = {}
        for v in ids:
            peers = rng.sample(ids, rng.randrange(2, n + 1))
            if v not in peers:
                peers.append(v)
            qmap[v] = TU.qset(rng.randrange(1, len(peers) + 1), peers)
        out.append(qmap)
    return out


_REF = {}


def reference(key, qmap, buckets=None):
    """The reference checker's result and frontier peak on `qmap`, once per
    (key, buckets) in this module."""
    if (key, buckets) not in _REF:
        ck = RQ.TPUQuorumIntersectionChecker(to_ref(qmap))
        if buckets is not None:
            ck.CAPACITY_BUCKETS = buckets
        _REF[key, buckets] = (ck.check(), ck._frontier_peak)
    return _REF[key, buckets]


def port(qmap, buckets=None, **kw):
    ck = Q.CudaQuorumIntersectionChecker(qmap, device="cpu", **kw)
    if buckets is not None:
        ck.CAPACITY_BUCKETS = buckets
    return ck.check(), ck


def assert_same(key, qmap, buckets=None):
    """Port and reference agree on everything; returns the port's result."""
    got, ck = port(qmap, buckets)
    want, peak = reference(key, qmap, buckets)
    assert got.intersects == want.intersects, key
    want_split = None if want.split is None else (list(want.split[0]),
                                                  list(want.split[1]))
    assert got.split == want_split, key
    assert got.max_quorums_found == want.max_quorums_found, key
    assert got.node_count == want.node_count, key
    assert got.main_scc_size == want.main_scc_size, key
    assert ck._frontier_peak == peak, key
    assert ck.stats == {"checks": 1, "nodes": got.node_count,
                        "frontier_peak": peak,
                        "quorum_hits": got.max_quorums_found}
    return got


def test_map_builders_equal_the_references():
    def xdr(qmap):
        return {k: v.to_xdr() for k, v in qmap.items()}
    for n in (3, 4, 5, 7):
        assert xdr(to_ref(TU.asym_org_qmap(n))) == \
            xdr(ref_testutils.asym_org_qmap(n))
    assert xdr(to_ref(TU.tier1_quorum_map())) == xdr(bench.tier1_quorum_map())
    assert xdr(to_ref(TU.adversarial_quorum_map())) == \
        xdr(bench.adversarial_quorum_map())
    assert TU.nid(300) == bytes([44, 1]) + bytes(30)


class TestDifferential:
    @pytest.mark.parametrize("n,thr", [(4, 3), (4, 2), (5, 3), (6, 4),
                                       (6, 3), (7, 5), (8, 4)])
    def test_flat_maps(self, n, thr):
        assert_same(("flat", n, thr), TU.flat_qmap(n, thr))

    def test_flat40_two_words(self):
        res = assert_same("flat40", TU.flat_qmap(40, 40))
        assert res.intersects and res.max_quorums_found == 1

    @pytest.mark.parametrize("n_orgs,top", [(3, 2), (4, 2), (4, 3), (5, 3),
                                            (5, 4), (7, 5)])
    def test_org_maps(self, n_orgs, top):
        assert_same(("org", n_orgs, top), TU.org_qmap(n_orgs, 3, top, 2))

    @pytest.mark.parametrize("trial", range(12))
    def test_random_maps(self, trial):
        assert_same(("random", trial), random_qmaps()[trial])

    def test_split_witness_is_two_quorums(self):
        qmap = TU.org_qmap(4, 3, 2, 2)  # 2-of-4 orgs: splits
        res = assert_same(("org", 4, 2), qmap)
        assert not res.intersects
        ck = PH.QuorumIntersectionChecker(qmap)
        mask = lambda names: sum(1 << ck.index[x] for x in names)
        a, b = res.split
        assert ck.is_quorum(mask(a)) and ck.is_quorum(mask(b))
        assert mask(a) & mask(b) == 0

    def test_tier1_split_map_of_chip_smoke(self):
        """org_qmap(7, 3, 3, 2), chip_smoke.py's main-quorum-split map."""
        res = assert_same("split7", TU.org_qmap(7, 3, 3, 2))
        assert not res.intersects and res.max_quorums_found == 16


class TestResidentFrontier:
    @pytest.mark.parametrize("n_orgs", [3, 4])
    def test_asym_org_maps(self, n_orgs):
        assert_same(("asym", n_orgs), TU.asym_org_qmap(n_orgs))

    @pytest.mark.parametrize("key,qmap,buckets", [
        (("org", 5, 3), TU.org_qmap(5, 3, 3, 2), (8, 16)),     # intersects
        (("org", 4, 2), TU.org_qmap(4, 3, 2, 2), (8, 16)),     # splits
        (("asym", 4), TU.asym_org_qmap(4), (8, 16)),
        (("org", 5, 3), TU.org_qmap(5, 3, 3, 2), (32,))])
    def test_tiny_buckets_force_overflow_ladders(self, key, qmap, buckets):
        """Buckets far below the real frontier take the fallbacks: the
        host-chunked depth before a segment (count * 2 > top bucket) and,
        with (32,), the in-segment overflow (freeze, then a chunked
        resume at the overflow depth)."""
        assert_same(key, qmap, buckets=buckets)

    @pytest.mark.parametrize("key,qmap,buckets", [
        (("org", 5, 3), TU.org_qmap(5, 3, 3, 2), (8, 16)),
        (("org", 4, 2), TU.org_qmap(4, 3, 2, 2), (8, 16)),
        (("asym", 4), TU.asym_org_qmap(4), (8, 16)),
        (("org", 5, 3), TU.org_qmap(5, 3, 3, 2), (32,))])
    def test_chunked_depths_stay_resident(self, monkeypatch, key, qmap,
                                          buckets):
        """One device: the depths the reference runs host-chunked run as
        one-depth segments into twice the frontier's rows; the host-chunked
        _prune is never called, and the results, frontier peak included,
        still equal the reference's."""
        def refuse(*args, **kw):
            raise AssertionError("the single-device checker chunked a depth")

        monkeypatch.setattr(Q.CudaQuorumIntersectionChecker, "_prune", refuse)
        widths = []
        real_step = Q.segment_step

        def record(*args, **kw):
            widths.append(kw.get("capacity"))
            return real_step(*args, **kw)

        monkeypatch.setattr(Q, "segment_step", record)
        assert_same(key, qmap, buckets=buckets)
        # some depths ran as the reference's chunked ones: past the top bucket
        assert any(c is not None and c > buckets[-1] for c in widths)

    def test_split_found_inside_segment(self):
        res = assert_same(("org", 4, 2), TU.org_qmap(4, 3, 2, 2),
                          buckets=(4096,))
        assert not res.intersects
        a, b = res.split
        assert set(a) & set(b) == set()

    @pytest.mark.parametrize("row_kind,branch", [
        ("zeros", "not a quorum"),
        ("all_nodes", "complement has no quorum")])
    def test_corrupt_device_witness_fails_stop(self, monkeypatch, row_kind,
                                               branch):
        """A fabricated witness row must raise, never report a split: both
        sides are re-checked on the CPU oracle."""
        qmap = TU.org_qmap(5, 3, 3, 2)            # intersecting, 15 nodes
        fill = 0 if row_kind == "zeros" else (1 << 15) - 1
        real_step = Q.segment_step

        def corrupted(*args, **kw):
            fr, meta, w_rows = real_step(*args, **kw)
            meta = np.asarray(meta).copy()
            meta[Q.SEG_DEPTHS] = 1               # one witness at depth 0
            return fr, meta, np.full_like(np.asarray(w_rows), fill)

        monkeypatch.setattr(Q, "segment_step", corrupted)
        with pytest.raises(RuntimeError, match=branch):
            Q.check_intersection_cuda(qmap, device="cpu")


class TestBigMap:
    def test_tier1_shape_21_nodes(self):
        res = assert_same(("org", 7, 5), TU.org_qmap(7, 3, 5, 2))
        assert res.intersects and res.node_count == 21

    def test_interrupt(self):
        with pytest.raises(PH.InterruptedError_):
            Q.check_intersection_cuda(TU.org_qmap(6, 3, 4, 2),
                                      interrupt=lambda: True, device="cpu")

    def test_deep_nesting_raises(self):
        a, b = TU.nid(1), TU.nid(2)
        deep = TU.qset(1, inner=[TU.qset(1, inner=[TU.qset(1, [a])])])
        with pytest.raises(ValueError):
            Q.CudaQuorumIntersectionChecker({a: deep, b: deep}, device="cpu")
        with pytest.raises(ValueError):
            RQ.TPUQuorumIntersectionChecker(to_ref({a: deep, b: deep}))

    @pytest.mark.parametrize("core,intersects", [((4, 3, 3, 2), True),
                                                 ((4, 3, 2, 2), False)])
    def test_more_than_256_nodes(self, core, intersects):
        """A core of org_qmap and 245 watcher nodes: 257 nodes, rows of 9
        words.  The port takes it (it refused more than 256 nodes before)
        and equals the reference, split included.  (A larger core's
        frontier fills the reference's larger buckets, whose [rows, nodes,
        words] intermediates outgrow a CPU's memory at this width.)"""
        qmap = TU.watched_org_qmap(*core, 245)
        res = assert_same(("watched", core), qmap)
        assert res.node_count == 257 and res.main_scc_size == 12
        assert res.intersects == intersects
        ck = Q.CudaQuorumIntersectionChecker(qmap, device="cpu")
        assert ck.n_words == 9 and Q.flags_path(ck.tables) == "wide"


# -- the oracle copy --------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda: TU.org_qmap(4, 3, 2, 2), lambda: TU.org_qmap(4, 3, 3, 2),
    lambda: TU.asym_org_qmap(3), lambda: TU.adversarial_quorum_map(9),
    lambda: TU.flat_qmap(6, 3)])
def test_oracle_copy_equals_the_references(make):
    qmap = make()
    got = PH.QuorumIntersectionChecker(qmap).check()
    want = RH.QuorumIntersectionChecker(to_ref(qmap))._check_python()
    assert (got.intersects, got.split, got.node_count, got.main_scc_size,
            got.max_quorums_found) == \
        (want.intersects, want.split, want.node_count, want.main_scc_size,
         want.max_quorums_found)
    assert PH.flatten_qmap(qmap) == RH.flatten_qmap(to_ref(qmap))


# -- function level: plain versions against the reference's programs ------

def _states(monkeypatch, qmap, buckets=None):
    """(checker, [segment_step arguments]) of a real port run on `qmap`."""
    seen = []
    real_step = Q.segment_step

    def record(*args, **kw):
        seen.append(tuple(a.clone() if isinstance(a, torch.Tensor) else
                          np.array(a) if isinstance(a, np.ndarray) else a
                          for a in args))
        return real_step(*args, **kw)

    monkeypatch.setattr(Q, "segment_step", record)
    ck = Q.CudaQuorumIntersectionChecker(qmap, device="cpu")
    if buckets is not None:
        ck.CAPACITY_BUCKETS = buckets
    ck.check()
    monkeypatch.undo()
    return ck, seen


def _u32(t):
    return np.asarray(t).astype(np.uint32)


@pytest.mark.parametrize("key,qmap,buckets,pick", [
    ("asym4", TU.asym_org_qmap(4), None, 2),
    ("split4", TU.org_qmap(4, 3, 2, 2), (4096,), -1),
    ("flat40", TU.flat_qmap(40, 40), None, 0),
    ("overflow", TU.org_qmap(5, 3, 3, 2), (32,), None)])
def test_segment_step_equals_reference(monkeypatch, key, qmap, buckets,
                                       pick):
    """A recorded segment state through the plain segment_step and the
    reference's _segment_step: frontier'[:count'], meta and the counted
    witness rows are equal."""
    ck, seen = _states(monkeypatch, qmap, buckets)
    if pick is None:     # the first segment that overflowed
        pick = next(i for i, s in enumerate(seen)
                    if int(Q.segment_step_plain(*s)[1][-1]) >= 0)
    fr, count, bits, rems, active, scc, tt, tm, it, im = seen[pick]
    got_fr, got_meta, got_rows = Q.segment_step_plain(*seen[pick])
    want_fr, want_meta, want_rows = RQ._segment_step(
        _u32(fr), jax.numpy.int32(count), _u32(bits), _u32(rems),
        np.asarray(active), _u32(scc), np.asarray(tt), _u32(tm),
        np.asarray(it), _u32(im))
    want_meta = np.asarray(want_meta)
    assert got_meta.tolist() == want_meta.tolist()
    n = int(want_meta[2 * Q.SEG_DEPTHS])
    assert (got_fr[:n].numpy() == np.asarray(want_fr)[:n]).all()
    for j in range(Q.SEG_DEPTHS):
        w = min(int(want_meta[Q.SEG_DEPTHS + j]), Q.WITNESS_CAP)
        assert (got_rows[j, :w].numpy() == np.asarray(want_rows)[j, :w]).all()
    if key == "split4":
        assert want_meta[Q.SEG_DEPTHS:2 * Q.SEG_DEPTHS].any()
    if key == "overflow":
        assert want_meta[-1] >= 0


@pytest.mark.parametrize("qmap", [TU.asym_org_qmap(4), TU.flat_qmap(40, 38),
                                  TU.org_qmap(4, 3, 2, 2)])
def test_prune_step_equals_reference(qmap):
    """Random children inside the main SCC, through the plain prune_step
    and the reference's _prune_step fed by convert.quorum_state_from_jax."""
    ref = RQ.TPUQuorumIntersectionChecker(to_ref(qmap))
    rng = np.random.default_rng(5)
    n, w = ref.n, ref.n_words
    bits = rng.random((256, n)) < rng.random((256, 1))
    children = RQ._masks_to_words(
        [sum(1 << i for i in np.nonzero(row)[0]) for row in bits], w)
    scc = RQ._masks_to_words([(1 << n) - 1], w)[0]
    rem = RQ._masks_to_words([((1 << n) - 1) >> (n // 2) << (n // 2)], w)[0]
    want = RQ._prune_step(children, rem, scc, ref.top_thr, ref.top_masks,
                          ref.inner_thr, ref.inner_masks)
    state = convert.quorum_state_from_jax(ref, children)
    got = Q.prune_step(state[0], convert.words_from_jax(rem),
                       convert.words_from_jax(scc), *state[1:])
    for g, x in zip(got, want):
        assert g.tolist() == np.asarray(x).tolist()
    assert any(np.asarray(x).any() for x in want[:2])


def test_popcount_tally_counts_the_kernels_work():
    """The tally is what K-QF's per-row loops issue: per fixpoint pass on a
    non-empty row, W popcounts for each distinct top mask and satisfiable
    inner pair ("distinct"), beside the (1 + K) W for each member of the
    set of a per-member design ("per_member")."""
    top_thr = torch.tensor([2, 2], dtype=torch.int32)
    top_masks = torch.tensor([[0b11], [0b11]])
    inner_thr = torch.tensor([[1], [Q._PAD_THR]], dtype=torch.int32)
    inner_masks = torch.tensor([[[0b100]], [[0]]])
    S = torch.tensor([[0b11], [0b01]])
    Q.popcount_tally = {"distinct": 0, "per_member": 0}
    try:
        out = Q.contract_fixpoint(S, top_thr, top_masks, inner_thr,
                                  inner_masks)
        # row 0: one pass over 2 members; row 1: a pass over 1 member
        # empties it, and the empty row's loop ends without a pass; one top
        # mask and one real pair (the padding is never satisfied)
        assert Q.popcount_tally == {"distinct": (1 + 1) * 2,
                                    "per_member": (2 + 1 + 0) * 2}
    finally:
        Q.popcount_tally = None
    assert out.tolist() == [[0b11], [0]]
    assert Q.popcount(torch.tensor([0, 1, 0xFFFFFFFF, 0x80000001])).tolist() \
        == [0, 1, 32, 2]
