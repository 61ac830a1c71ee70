"""The port's per-key window tables against the JAX package's
accel/tables.py (CPU, exact equality): table build, table-path verify, a
JAX-built key table carried in through convert.py, and KeyTableCache's slot,
LRU and protect behaviour over one call sequence."""

import hashlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from stellar_core_tpu_torch import convert
from stellar_core_tpu_torch.accel import ed25519 as TE
from stellar_core_tpu_torch.accel import field as TF
from stellar_core_tpu_torch.accel import tables as TT
from stellar_core_tpu_torch.crypto import sodium

Tj = pytest.importorskip("stellar_core_tpu.accel.tables")
Ej = pytest.importorskip("stellar_core_tpu.accel.ed25519")
jnp = pytest.importorskip("jax.numpy")

KEYS = [sodium.sign_seed_keypair(bytes([40 + i]) * 32) for i in range(6)]
N_SIGS = 8   # signatures through the reference's table verify


def _xy_ints(pk):
    dec = TE.Ed25519BatchVerifier._decode_pk(pk)
    return [int.from_bytes(dec[c].tobytes(), "little") for c in range(2)]


@pytest.fixture(scope="module")
def jax_table():
    """The reference's build at its own launch width (BUILD_K = 32 rows):
    row 0 the base point B, rows 1..3 -A of KEYS[0..2], the rest the
    padding point (0, 1) as KeyTableCache.install pads."""
    ax = np.zeros((Tj.BUILD_K, 16), dtype=np.int64)
    ay = np.zeros((Tj.BUILD_K, 16), dtype=np.int64)
    ay[:, 0] = 1
    ax[0], ay[0] = TF.int_to_limbs(TT.BX), TF.int_to_limbs(TT.BY)
    for j in range(3):
        x, y = _xy_ints(KEYS[j][0])
        ax[1 + j], ay[1 + j] = TF.int_to_limbs(x), TF.int_to_limbs(y)

    def warm_verify():
        # the reference's table verify at the shapes of the tests below
        z = np.zeros((N_SIGS, 32), dtype=np.uint8)
        tab = jnp.asarray(np.zeros((Tj.BUILD_K, 64, 16, 4, 16), np.int64))
        Tj._verify_tables_jit(z, z, np.zeros(N_SIGS, np.int32), z, tab,
                              tab[0]).block_until_ready()

    # XLA compiles outside the GIL: compile the build and the verify at once
    with ThreadPoolExecutor(1) as pool:
        warm = pool.submit(warm_verify)
        table = np.asarray(Tj._build_jit(jnp.asarray(ax), jnp.asarray(ay)))
        warm.result()
    return table, ax, ay


def test_build_tables_matches_reference(jax_table):
    table, ax, ay = jax_table
    got = TT.build_tables(torch.from_numpy(ax[:2]), torch.from_numpy(ay[:2]))
    assert got.shape == (2, 64, 16, 4, 16)
    assert np.array_equal(TF.to_bytes(got).numpy(),
                          convert.canonical_bytes(table[:2]))
    # the in-place slot writer, from canonical (x, y) encodings
    xy = np.stack([TF.to_bytes(torch.from_numpy(a[:2])).numpy() for a in (ax, ay)],
                  axis=1)
    tab = TT.new_table(3, "cpu")
    TT.build_tables_into(tab, torch.tensor([2, 0], dtype=torch.int32),
                         torch.from_numpy(xy))
    assert tab.dtype == torch.uint8 and not tab[1].any()
    # the resident format (canonical bytes, what the kernels store too)
    # agrees from either side
    assert np.array_equal(tab[[2, 0]].numpy(), convert.canonical_bytes(table[:2]))


def _signatures(n, corrupt_every=3):
    pks, sigs, msgs = [], [], []
    for i in range(n):
        pk, sk = KEYS[i % 3]
        msg = bytes([i]) * (i + 5)
        sig = sodium.sign_detached(msg, sk)
        if i % corrupt_every == corrupt_every - 1:
            sig = sig[:32] + bytes([sig[32] ^ 4]) + sig[33:]
        pks.append(pk)
        sigs.append(sig)
        msgs.append(msg)
    s = np.stack([np.frombuffer(sg[32:], np.uint8) for sg in sigs])
    r = np.stack([np.frombuffer(sg[:32], np.uint8) for sg in sigs])
    h = np.stack([np.frombuffer((int.from_bytes(
        hashlib.sha512(sg[:32] + pk + m).digest(), "little") % TE.L)
        .to_bytes(32, "little"), np.uint8) for pk, sg, m in zip(pks, sigs, msgs)])
    slots = np.array([1 + i % 3 for i in range(n)], dtype=np.int32)
    expect = [sodium.verify_detached(sg, m, pk) for pk, sg, m in zip(pks, sigs, msgs)]
    return s, h, r, slots, expect


def test_verify_tables_forward_matches_reference(jax_table):
    table, ax, ay = jax_table
    s, h, r, slots, expect = _signatures(N_SIGS)
    ref = np.asarray(Tj._verify_tables_jit(s, h, slots, r, jnp.asarray(table),
                                           jnp.asarray(table[0])))
    port_tab = TF.to_bytes(TT.build_tables(torch.from_numpy(ax[:4]),
                                           torch.from_numpy(ay[:4])))
    t = torch.from_numpy
    got = TT.verify_tables_forward(t(s), t(h), t(slots), t(r), port_tab, port_tab[0])
    assert got.tolist() == ref.tolist() == expect
    assert not all(expect) and any(expect)


def test_jax_key_table_through_convert(jax_table):
    """The reference's own table, carried in, drives the port's table
    verify to the reference's verdicts."""
    table, _, _ = jax_table
    s, h, r, slots, expect = _signatures(6, corrupt_every=2)
    slot_of = {KEYS[j][0]: 1 + j for j in range(3)}
    cache = convert.key_table_from_jax(table, slot_of, device="cpu")
    assert cache.slot_of == slot_of and cache.lookup(KEYS[1][0]) == 2
    base = torch.from_numpy(convert.canonical_bytes(table[0]))
    t = torch.from_numpy
    got = TT.verify_tables(t(s), t(h), t(slots), t(r), cache.table, base)
    assert got.tolist() == expect


def test_key_table_cache_matches_reference(jax_table):
    """Slots handed out highest-free-first, LRU eviction that skips the
    protect set, and omission when every slot is protected: slot_of, the
    LRU ticks and the built rows equal the reference's after each step."""
    ref = Tj.KeyTableCache(slots=4)
    port = TT.KeyTableCache(4, device="cpu")
    pk = [k[0] for k in KEYS]
    ref_dec = {p: Ej.Ed25519BatchVerifier._decode_pk(p) for p in pk}
    port_dec = {p: TE.Ed25519BatchVerifier._decode_pk(p) for p in pk}

    def step(keys, protect=frozenset()):
        a = ref.install([(p, ref_dec[p]) for p in keys], protect=protect)
        b = port.install([(p, port_dec[p]) for p in keys], protect=protect)
        assert a == b
        assert port.slot_of == ref.slot_of
        assert port._last_used == ref._last_used and port._tick == ref._tick
        return b

    assert step(pk[:3]) == {pk[0]: 3, pk[1]: 2, pk[2]: 1}
    assert port.lookup(pk[0]) == ref.lookup(pk[0]) == 3
    assert port.lookup(pk[5]) is ref.lookup(pk[5]) is None
    # one free slot (0), then the least recently used unprotected key (pk[2])
    got = step(pk[3:5], protect=frozenset({pk[1], pk[3], pk[4]}))
    assert got == {pk[3]: 0, pk[4]: 1} and pk[2] not in port.slot_of
    # every resident key protected: nothing is evicted, pk[5] gets no slot
    assert step([pk[5]], protect=frozenset(port.slot_of)) == {}
    used = sorted(port.slot_of.values())
    assert np.array_equal(port.table[used].numpy(),
                          convert.canonical_bytes(np.asarray(ref.table)[used]))


def test_generic_key_rows_through_convert():
    """The reference's generic-path key limbs (its pk cache's (cx, cy, ct)
    of -A) become the port's key rows, byte for byte."""
    pks = [k[0] for k in KEYS]
    dec = [Ej.Ed25519BatchVerifier._decode_pk(p) for p in pks]
    rows = convert.key_rows_from_jax(*(np.stack([d[c] for d in dec])
                                       for c in range(3)))
    assert np.array_equal(rows, np.stack(
        [TE.Ed25519BatchVerifier._decode_pk(p) for p in pks]))
