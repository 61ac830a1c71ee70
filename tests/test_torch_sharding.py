"""The port's multi-device forms on the CPU: the batch verifier and the
quorum checker with ``devices=["cpu"] * k`` (k shards on the one CPU)
against their single-device forms and the JAX package.

* ``device.parts`` splits a batch into contiguous, ordered parts.
* Sharded verify: a hot-and-cold adversarial batch through three shards
  (a chunk shorter than the device count included) gives the verdicts,
  stats and table slots of ``device="cpu"``, of the JAX package's verifier
  (its sharded form, over the eight virtual CPU devices the tests pin) and
  of libsodium, call after call.
* Sharded prune: two shards equal the CPU oracle and the JAX package's
  single-device checker (``mesh=None``; its mesh path does not run on the
  installed jax) on asym4, the split map and both dry-run maps.
* The key tables' replicas: one slot map, each mirror device's table built
  from the same slots and key bytes.
"""

import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from stellar_core_tpu_torch import device as D
from stellar_core_tpu_torch import graft_entry
from stellar_core_tpu_torch import testutils as TU
from stellar_core_tpu_torch.accel import ed25519 as TE
from stellar_core_tpu_torch.accel import quorum as Q
from stellar_core_tpu_torch.accel import tables as TT
from stellar_core_tpu_torch.crypto import sodium
from stellar_core_tpu_torch.herder.quorum_intersection import (
    QuorumIntersectionChecker)

jax = pytest.importorskip("jax")
Ej = pytest.importorskip("stellar_core_tpu.accel.ed25519")
RQ = pytest.importorskip("stellar_core_tpu.accel.quorum")
from stellar_core_tpu.xdr import scp as SX  # noqa: E402
from stellar_core_tpu.xdr import types as XT  # noqa: E402

CHUNK = 8
SHARDS = 3
CPU = torch.device("cpu")


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_parts_are_contiguous_and_ordered(k):
    for n in range(0, 23):
        got = D.parts(n, k)
        assert len(got) == k
        assert [i for lo, hi in got for i in range(lo, hi)] == list(range(n))
        sizes = [hi - lo for lo, hi in got]
        assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes)[::-1]


def test_resolve_shards():
    assert D.resolve_shards(devices=["cpu"] * 3) == (CPU,) * 3
    assert D.resolve_shards(device="cpu") == (CPU,)
    with pytest.raises(ValueError, match="not both"):
        D.resolve_shards("cpu", ["cpu"])
    with pytest.raises(ValueError, match="empty"):
        D.resolve_shards(devices=[])
    shards = D.Shards((CPU,) * 2)
    assert shards.streams == (None, None) and len(shards) == 2
    with shards.on(1) as dev:
        assert dev == CPU
    assert shards.join(1) is None


def _batch(seed):
    """One hot key (12 uses) and ten cold keys, every fifth R corrupted, a
    wrong message and a non-canonical S: 24 signatures."""
    rng = random.Random(seed)
    hot_pk, hot_sk = sodium.sign_seed_keypair(bytes([seed, 1]) * 16)
    cases = []
    for i in range(24):
        if i % 2 == 0:
            pk, sk = hot_pk, hot_sk
        else:
            pk, sk = sodium.sign_seed_keypair(bytes([seed, 2 + i]) * 16)
        msg = rng.randbytes(rng.randrange(0, 40))
        sig = sodium.sign_detached(msg, sk)
        if i % 5 == 4:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        cases.append((pk, sig, msg))
    pk, sig, msg = cases[3]
    cases[3] = (pk, sig, msg + b"!")
    pk, sig, msg = cases[7]
    s = int.from_bytes(sig[32:], "little") + TE.L
    cases[7] = (pk, sig[:32] + s.to_bytes(32, "little"), msg)
    return cases


def _warm(ref):
    """Compile the reference's three device programs (table build, sharded
    table verify, sharded generic verify, at the one padded shape this test
    sends) at once: XLA compiles outside the GIL, and compiling is nearly
    all of this test's time.  The verdicts come from the real calls."""
    Tj = pytest.importorskip("stellar_core_tpu.accel.tables")
    jnp = pytest.importorskip("jax.numpy")

    def zeros(shape, dtype):
        return jnp.asarray(np.zeros(shape, dtype=dtype))

    def warm_build():
        if Tj._base_table is None:
            # B's table at the install width (B first), as the install
            # builds keys: one table-build program, not two
            ax = np.zeros((Tj.BUILD_K, 16), dtype=np.int64)
            ay = np.zeros((Tj.BUILD_K, 16), dtype=np.int64)
            ay[:, 0] = 1
            ax[0] = Ej.field.int_to_limbs(TT.BX)
            ay[0] = Ej.field.int_to_limbs(TT.BY)
            Tj._base_table = Tj._build_jit(jnp.asarray(ax), jnp.asarray(ay))[0]

    def warm_tables():
        base = zeros((1, 64, 16, 4, 16), np.int64)
        table = zeros((192, 64, 16, 4, 16), np.int64).at[
            jnp.asarray(np.zeros(1, np.int32))].set(base)
        ref._kernel_tables(zeros((CHUNK, 32), np.uint8),
                           zeros((CHUNK, 32), np.uint8),
                           zeros(CHUNK, np.int32), zeros((CHUNK, 32), np.uint8),
                           table, base[0]).block_until_ready()

    def warm_generic():
        keys = zeros((64, 16), np.int64)
        ref._kernel_raw(zeros((CHUNK, 32), np.uint8),
                        zeros((CHUNK, 32), np.uint8), zeros(CHUNK, np.int32),
                        keys, keys, keys,
                        zeros((CHUNK, 32), np.uint8)).block_until_ready()

    with ThreadPoolExecutor(3) as pool:
        for f in [pool.submit(w) for w in (warm_build, warm_tables,
                                           warm_generic)]:
            f.result()


def test_sharded_verify_equals_one_device_jax_and_libsodium():
    ref = Ej.Ed25519BatchVerifier(chunk_size=CHUNK)
    _warm(ref)
    one = TE.Ed25519BatchVerifier(chunk_size=CHUNK, device="cpu")
    many = TE.Ed25519BatchVerifier(chunk_size=CHUNK, devices=["cpu"] * SHARDS)
    assert many.devices == (CPU,) * SHARDS and many.device == CPU
    for seed in (1, 2):
        # 12 hot signatures (chunks of 8 and 4) and 12 cold (8 and 4); the
        # second call adds 2 cold ones: a chunk of 2, shorter than the
        # device count, and an empty part
        cases = _batch(seed) + _batch(seed + 10)[1:4:2]
        pks, sigs, msgs = (list(c) for c in zip(*cases))
        expect = [sodium.verify_detached(s, m, p) for p, s, m in cases]
        got = many.verify(pks, sigs, msgs).tolist()
        assert got == one.verify(pks, sigs, msgs).tolist() == expect
        assert ref.verify(pks, sigs, msgs).tolist() == expect
        assert many.stats == one.stats == ref.stats
        assert many._tables.slot_of == one._tables.slot_of == \
            ref._tables.slot_of
    assert many.stats["table_sigs"] > 0 and many.stats["generic_sigs"] > 0


def test_sharded_plan_splits_every_chunk():
    v = TE.Ed25519BatchVerifier(chunk_size=CHUNK, devices=["cpu"] * SHARDS)
    plan = list(v._plan(2 * CHUNK + 2))
    # chunks of 8, 8, 2: parts (3, 3, 2), (3, 3, 2), (1, 1, 0)
    assert [(k, spans) for k, _, _, spans in plan] == [
        (0, [(0, 3, 0), (8, 11, 3), (16, 17, 6)]),
        (1, [(3, 6, 0), (11, 14, 3), (17, 18, 6)]),
        (2, [(6, 8, 0), (14, 16, 2)])]
    assert plan[2][2].tolist() == [6, 7, 14, 15]
    assert [(k, spans) for k, _, _, spans in TE.Ed25519BatchVerifier(
        chunk_size=CHUNK, device="cpu")._plan(10)] == [
            (0, [(0, 8, 0), (8, 10, 8)])]


def test_verify_batch_caches_a_verifier_per_device_tuple():
    cases = _batch(3)[:4]
    args = [list(c) for c in zip(*cases)]
    want = [sodium.verify_detached(s, m, p) for p, s, m in cases]
    assert TE.verify_batch(*args, chunk_size=4, hot_threshold=1 << 62,
                           devices=["cpu"] * 2).tolist() == want
    assert TE.verify_batch_async(*args, chunk_size=4, hot_threshold=1 << 62,
                                 device="cpu")().tolist() == want
    assert (4, 256, 1 << 62, (CPU, CPU)) in TE._verifiers
    assert (4, 256, 1 << 62, (CPU,)) in TE._verifiers
    with pytest.raises(ValueError, match="not both"):
        TE.verify_batch(*args, device="cpu", devices=["cpu"])


def test_key_table_replicas_share_one_slot_map(monkeypatch):
    """A mirror device gets its own table, built from the same slots and
    key bytes as the first device's (here a mirror on the meta device,
    whose builds are recorded instead of run)."""
    meta = torch.device("meta")
    cache = TT.KeyTableCache(4, device="cpu", mirrors=["cpu", meta, meta])
    assert cache.mirrors == (meta,)
    built, sent = [], []
    real = TT.build_tables_into

    def record(table, slots, xy):
        built.append(table.device)
        return real(table, slots, xy) if table.device == CPU else table

    def upload(a, dev):
        sent.append((torch.device(dev), a.tolist()))
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    monkeypatch.setattr(TT, "build_tables_into", record)
    monkeypatch.setattr(TT, "upload", upload)
    pk = sodium.sign_seed_keypair(bytes(32))[0]
    dec = TE.Ed25519BatchVerifier._decode_pk(pk)
    assert cache.install([(pk, dec)]) == {pk: 3}
    assert cache.slot_of == {pk: 3}
    assert cache.table_on("cpu") is cache.table
    assert cache.table_on(meta).device == meta
    assert cache.table_on(meta).shape == cache.table.shape
    assert built == [CPU, meta]
    # the same slots and key bytes to both devices
    assert [d for d, _ in sent] == [CPU, CPU, meta, meta]
    assert sent[0][1] == sent[2][1] == [3] and sent[1][1] == sent[3][1]


def _to_ref(qmap):
    def conv(q):
        return SX.SCPQuorumSet(
            threshold=q.threshold,
            validators=[XT.node_id(v.value) for v in q.validators],
            innerSets=[conv(i) for i in q.innerSets])
    return {k: conv(v) for k, v in qmap.items()}


_safe, _split = graft_entry._dryrun_qmaps()


@pytest.mark.parametrize("name,qmap,batch", [
    ("asym4", TU.asym_org_qmap(4), 64),
    ("split", TU.org_qmap(7, 3, 3, 2), 8),
    ("dryrun-safe", _safe, 4096),
    ("dryrun-split", _split, 4)])
def test_sharded_prune_equals_oracle_and_jax(name, qmap, batch):
    got_ck = Q.CudaQuorumIntersectionChecker(qmap, batch_size=batch,
                                             devices=["cpu"] * 2)
    launches = Q.flags_kernel.launches
    got = got_ck.check()
    assert Q.flags_kernel.launches == launches
    one = Q.check_intersection_cuda(qmap, device="cpu")
    ref = RQ.check_intersection_tpu(_to_ref(qmap))     # mesh=None
    oracle = QuorumIntersectionChecker(qmap)
    assert got.intersects == one.intersects == ref.intersects \
        == oracle.check().intersects, name
    ref_split = None if ref.split is None else (list(ref.split[0]),
                                                list(ref.split[1]))
    assert got.split == one.split == ref_split, name
    assert got.max_quorums_found == one.max_quorums_found \
        == ref.max_quorums_found, name
    assert (got.node_count, got.main_scc_size) == \
        (ref.node_count, ref.main_scc_size), name
    if not got.intersects:
        # the split is a pair of disjoint quorums, by the oracle's rules
        a, b = (sum(1 << oracle.index[v] for v in side) for side in got.split)
        assert oracle.is_quorum(a) and oracle.is_quorum(b) and not a & b
