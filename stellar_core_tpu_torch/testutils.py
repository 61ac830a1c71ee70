"""Quorum maps for the tests and chip_smoke.py, on the port's XDR types.

Copies of ``stellar_core_tpu.testutils.asym_org_qmap``, the ``org_qmap``
and flat maps of tests/test_accel_quorum.py, and bench.py's
``tier1_quorum_map`` and ``adversarial_quorum_map``.  Node ids are byte for
byte the reference's, so two checkers' splits compare as node lists.
"""

from __future__ import annotations

from .xdr.scp import NodeID, SCPQuorumSet


def nid(i: int) -> bytes:
    """Node id i of the test maps: two little-endian bytes, then zeros."""
    return bytes([i & 0xFF, i >> 8]) + bytes(30)


def qset(threshold, validators=(), inner=()) -> SCPQuorumSet:
    return SCPQuorumSet(threshold=threshold,
                        validators=[NodeID.ed25519(v) for v in validators],
                        innerSets=list(inner))


def flat_qmap(n: int, thr: int):
    """n nodes, each requiring thr of all n (flat40 is flat_qmap(40, 40))."""
    ids = [nid(i) for i in range(n)]
    q = qset(thr, ids)
    return {v: q for v in ids}


def org_qmap(n_orgs: int, org_size: int, top_thr: int, inner_thr: int):
    """n_orgs orgs of org_size validators; every node requires top_thr orgs,
    each satisfied by inner_thr of its members."""
    orgs = [[nid(100 * o + i) for i in range(org_size)]
            for o in range(n_orgs)]
    top = qset(top_thr, inner=[qset(inner_thr, org) for org in orgs])
    return {v: top for org in orgs for v in org}


def watched_org_qmap(n_orgs: int, org_size: int, top_thr: int,
                     inner_thr: int, watchers: int):
    """org_qmap's core and `watchers` more nodes (ids 1000, 1001, ...), each
    with a core node's qset; no node trusts a watcher, so the
    quorum-bearing SCC is the core and the search stays the core's.  Past
    256 nodes in all, a row takes more than 8 words."""
    qmap = org_qmap(n_orgs, org_size, top_thr, inner_thr)
    core = next(iter(qmap.values()))
    for j in range(watchers):
        qmap[nid(1000 + j)] = core
    return qmap


def scattered_qmap(n: int, k: int, seed: int):
    """n nodes, each with its own qset: itself and 3 random others as
    validators and k inner sets of 3 random nodes (2 of 3), a majority of
    the k + 4 entries required.  Nearly every inner set is distinct, so the
    map's flag tables grow with n k (n = 256, k = 16: too large for a
    block's shared memory)."""
    import random
    rng = random.Random(seed)
    ids = [nid(i) for i in range(n)]
    qmap = {}
    for i, v in enumerate(ids):
        others = rng.sample([u for u in ids if u != v], 3)
        inner = [qset(2, rng.sample(ids, 3)) for _ in range(k)]
        qmap[v] = qset((k + 4) // 2 + 1, [v] + others, inner)
    return qmap


def asym_org_qmap(n_orgs: int):
    """bench.py config 5's exponential class: org sizes cycle 3/4/5
    (majority inner thresholds) and each org's nodes carry a distinct qset
    (the org list rotated per org), so no symmetric contraction applies and
    the exact checker must enumerate."""
    sizes = [3 + (i % 3) for i in range(n_orgs)]
    orgs = [[bytes([o + 1]) * 31 + bytes([v]) for v in range(sz)]
            for o, sz in enumerate(sizes)]

    def inner(o):
        return qset(sizes[o] // 2 + 1, orgs[o])

    qmap = {}
    thr = (2 * n_orgs + 2) // 3
    for o in range(n_orgs):
        q = qset(thr, inner=[inner((o + j) % n_orgs) for j in range(n_orgs)])
        for m in orgs[o]:
            qmap[m] = q
    return qmap


def tier1_quorum_map(n_orgs: int = 9):
    """bench.py config #3: orgs x 3 validators, inner sets 2-of-3, top
    threshold 2/3 of the orgs (the pubnet tier-1 shape)."""
    per_org = 3
    ids = [bytes([o + 1]) * 31 + bytes([v]) for o in range(n_orgs)
           for v in range(per_org)]
    inner = [qset(2, ids[o * per_org:(o + 1) * per_org])
             for o in range(n_orgs)]
    q = qset((2 * n_orgs + 2) // 3, inner=inner)
    return {v: q for v in ids}


def adversarial_quorum_map(n: int = 16):
    """bench.py config #5's rings16: n nodes, each requiring 4 of itself
    and its next 5 ring neighbours."""
    ids = [bytes([i + 1]) * 32 for i in range(n)]
    return {ids[i]: qset(4, [ids[(i + d) % n] for d in range(6)])
            for i in range(n)}
