"""Three-way differential of batch Ed25519 verification: libsodium, the JAX
package's verifier and the port's (``device="cpu"``, the plain versions).

Mirrors the eight cases of tests/test_accel_ed25519.py on the same seeded
inputs, plus the hot_threshold boundary.  One fresh verifier on each side
sees the same call sequence, so after every call the port's ``stats`` and
table slots must equal the reference's (the module-level ``_verifiers``
cache of either package would carry state in from other tests)."""

import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from stellar_core_tpu_torch.accel import curve as TC
from stellar_core_tpu_torch.accel import ed25519 as TE
from stellar_core_tpu_torch.crypto import sodium

Ej = pytest.importorskip("stellar_core_tpu.accel.ed25519")

CHUNK = 32
P = (1 << 255) - 19
L = (1 << 252) + 27742317777372353535851937790883648493


@pytest.fixture(scope="module")
def pair():
    Tj = pytest.importorskip("stellar_core_tpu.accel.tables")
    jnp = pytest.importorskip("jax.numpy")
    ref = Ej.Ed25519BatchVerifier(chunk_size=CHUNK)

    def zeros(shape, dtype):
        return jnp.asarray(np.zeros(shape, dtype=dtype))

    def warm_build():
        if Tj._base_table is None:
            # the reference builds B's table lazily at width 1; build it at
            # the install width (BUILD_K rows, B first) instead, so this
            # module compiles one table build, not two.  Same integer
            # program per row, same entries.
            ax = np.zeros((Tj.BUILD_K, 16), dtype=np.int64)
            ay = np.zeros((Tj.BUILD_K, 16), dtype=np.int64)
            ay[:, 0] = 1
            ax[0] = Ej.field.int_to_limbs(TC.BX)
            ay[0] = Ej.field.int_to_limbs(TC.BY)
            Tj._base_table = Tj._build_jit(jnp.asarray(ax), jnp.asarray(ay))[0]

    def warm_tables():
        # a resident table made the way KeyTableCache.install makes it
        base = zeros((1, 64, 16, 4, 16), np.int64)
        table = zeros((192, 64, 16, 4, 16), np.int64).at[
            jnp.asarray(np.zeros(1, np.int32))].set(base)
        ref._kernel_tables(zeros((CHUNK, 32), np.uint8), zeros((CHUNK, 32), np.uint8),
                           zeros(CHUNK, np.int32), zeros((CHUNK, 32), np.uint8),
                           table, base[0]).block_until_ready()

    def warm_generic():
        keys = zeros((64, 16), np.int64)
        ref._kernel_raw(zeros((CHUNK, 32), np.uint8), zeros((CHUNK, 32), np.uint8),
                        zeros(CHUNK, np.int32), keys, keys, keys,
                        zeros((CHUNK, 32), np.uint8)).block_until_ready()

    # Compile the reference's three device programs (table build, table
    # verify, generic verify, at the one padded shape this module sends)
    # at once: XLA compiles outside the GIL, and compiling is nearly all of
    # this module's time.  The verdicts come from the real calls below.
    with ThreadPoolExecutor(3) as pool:
        for f in [pool.submit(w) for w in (warm_build, warm_tables, warm_generic)]:
            f.result()
    return ref, TE.Ed25519BatchVerifier(chunk_size=CHUNK, device="cpu")


def _keypair(rng):
    seed = bytes(rng.randrange(256) for _ in range(32))
    return sodium.sign_seed_keypair(seed)


def _three_way(pair, cases):
    """cases: list of (pk, sig, msg).  Asserts libsodium == JAX == port
    verdicts and equal stats and slots; returns the verdicts."""
    ref, port = pair
    pks = [c[0] for c in cases]
    sigs = [c[1] for c in cases]
    msgs = [c[2] for c in cases]
    expect = np.array([sodium.verify_detached(s, m, p) for p, s, m in cases])
    got_ref = ref.verify(pks, sigs, msgs)
    got = port.verify(pks, sigs, msgs)
    mism = np.nonzero((got != expect) | (got_ref != expect))[0]
    assert len(mism) == 0, (
        f"verdict mismatch at {mism.tolist()}: libsodium "
        f"{expect[mism].tolist()} jax {got_ref[mism].tolist()} "
        f"port {got[mism].tolist()}")
    assert port.stats == ref.stats
    assert port._tables.slot_of == ref._tables.slot_of
    return expect


def test_honest_and_corrupted_signatures(pair):
    rng = random.Random(42)
    cases = []
    for i in range(24):
        pk, sk = _keypair(rng)
        msg = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 150)))
        sig = sodium.sign_detached(msg, sk)
        kind = i % 6
        if kind == 1:
            sig = bytes([sig[0] ^ 1]) + sig[1:]               # corrupt R
        elif kind == 2:
            sig = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]  # corrupt S
        elif kind == 3:
            msg = msg + b"!"                                  # wrong message
        elif kind == 4:
            pk2, _ = _keypair(rng)
            pk = pk2                                          # wrong key
        cases.append((pk, sig, msg))
    assert _three_way(pair, cases).sum() >= 4


def test_scalar_malleability_rejected(pair):
    """S' = S + L verifies in naive implementations; all three reject."""
    rng = random.Random(43)
    cases = []
    for _ in range(4):
        pk, sk = _keypair(rng)
        msg = b"malleability"
        sig = sodium.sign_detached(msg, sk)
        s_int = int.from_bytes(sig[32:], "little")
        cases.append((pk, sig, msg))
        cases.append((pk, sig[:32] + (s_int + L).to_bytes(32, "little"), msg))
    assert list(_three_way(pair, cases)) == [True, False] * 4


def test_high_bit_s_rejected(pair):
    rng = random.Random(44)
    pk, sk = _keypair(rng)
    sig = sodium.sign_detached(b"m", sk)
    _three_way(pair, [(pk, sig[:63] + bytes([sig[63] | 0xE0]), b"m")])


def test_small_order_R_and_pk(pair):
    """All 14 small-order encodings in both the R and pk positions."""
    rng = random.Random(45)
    pk, sk = _keypair(rng)
    sig = sodium.sign_detached(b"torsion", sk)
    cases = []
    for base in (0, 1, TE._Y8A, TE._Y8B, P - 1, P, P + 1):
        for sign in (0, 0x80):
            b = bytearray(base.to_bytes(32, "little"))
            b[31] |= sign
            cases.append((pk, bytes(b) + sig[32:], b"torsion"))  # small-order R
            cases.append((bytes(b), sig, b"torsion"))            # small-order pk
    assert not _three_way(pair, cases).any()
    assert (TE._Y8A, TE._Y8B) == (Ej._Y8A, Ej._Y8B)


def test_noncanonical_and_undecodable_pk(pair):
    rng = random.Random(46)
    _, sk = _keypair(rng)
    sig = sodium.sign_detached(b"x", sk)
    cases = [(y.to_bytes(32, "little"), sig, b"x") for y in (P + 2, P + 3)]
    found, y = 0, 2
    while found < 3:   # undecodable y (no square root): the host rejects it
        if TC._recover_x(y, 0) is None:
            cases.append((y.to_bytes(32, "little"), sig, b"x"))
            found += 1
        y += 1
    assert not _three_way(pair, cases).any()


def test_torsion_mixed_pk_matches_libsodium(pair):
    """pk' = A + (order-8 point): whatever libsodium says, both say too."""
    rng = random.Random(47)
    cases = []
    t8 = (TC._recover_x(TE._Y8A, 0), TE._Y8A)
    for _ in range(4):
        pk, sk = _keypair(rng)
        msg = b"mixed order"
        sig = sodium.sign_detached(msg, sk)
        y = int.from_bytes(pk, "little") & ((1 << 255) - 1)
        mixed = TE._edwards_add_affine((TC._recover_x(y, pk[31] >> 7), y), t8)
        enc = bytearray(mixed[1].to_bytes(32, "little"))
        enc[31] |= (mixed[0] & 1) << 7
        cases.append((bytes(enc), sig, msg))
        cases.append((pk, sig, msg))
    _three_way(pair, cases)


def test_batch_chunking_and_duplicates(pair):
    """One key 35 times: it turns hot, so both sides build its table and
    verify on the table path, over a second, partial chunk."""
    rng = random.Random(48)
    pk, sk = _keypair(rng)
    sig = sodium.sign_detached(b"dup", sk)
    before = dict(pair[1].stats)
    assert _three_way(pair, [(pk, sig, b"dup")] * (CHUNK + 3)).all()
    assert pair[1].stats["table_sigs"] - before["table_sigs"] == CHUNK + 3
    assert pair[1].stats["tables_built"] - before["tables_built"] == 1


def test_wrong_length_inputs(pair):
    rng = random.Random(49)
    pk, sk = _keypair(rng)
    sig = sodium.sign_detached(b"z", sk)
    args = ([pk, pk[:31], pk], [sig[:63], sig, sig], [b"z", b"z", b"z"])
    assert list(pair[0].verify(*args)) == list(pair[1].verify(*args)) \
        == [False, False, True]
    assert pair[1].stats == pair[0].stats
    assert list(TE.verify_batch(*args, chunk_size=CHUNK, device="cpu")) == \
        [False, False, True]


def test_hot_threshold_boundary(pair):
    """A key's uses count across calls: below hot_threshold it stays on the
    generic path; the call that reaches the threshold installs its table and
    sends that call's signatures down the table path."""
    rng = random.Random(50)
    thr = pair[1].hot_threshold
    pk, sk = _keypair(rng)
    msgs = [bytes([i]) * 9 for i in range(thr)]
    sigs = [sodium.sign_detached(m, sk) for m in msgs]
    sigs[1] = sigs[1][:32] + bytes(32)     # one bad signature
    before = dict(pair[1].stats)
    _three_way(pair, [(pk, s, m) for s, m in zip(sigs[:-1], msgs[:-1])])
    mid = dict(pair[1].stats)
    assert mid["generic_sigs"] - before["generic_sigs"] == thr - 1
    assert mid["tables_built"] == before["tables_built"]
    assert pk not in pair[1]._tables.slot_of
    _three_way(pair, [(pk, sigs[-1], msgs[-1]), (pk, sigs[1], msgs[1])])
    after = pair[1].stats
    assert after["tables_built"] - mid["tables_built"] == 1
    assert after["table_sigs"] - mid["table_sigs"] == 2
    assert after["generic_sigs"] == mid["generic_sigs"]


def test_tail_floor_keys_its_own_verifier(monkeypatch):
    """As in the reference, verify_batch calls that differ only in
    tail_floor use two cached verifiers, so their pk caches, key use counts
    and stats stay apart."""
    monkeypatch.setattr(TE, "_verifiers", {})
    monkeypatch.setattr(Ej, "_verifiers", {})
    rng = random.Random(51)
    pk, sk = _keypair(rng)
    args = ([pk], [sodium.sign_detached(b"t", sk)], [b"t"])
    for floor in (64, 256):
        assert TE.verify_batch(*args, chunk_size=CHUNK, tail_floor=floor,
                               device="cpu").tolist() == [True]
        Ej._verifier_for(CHUNK, floor, 4)
    assert {k[:3] for k in TE._verifiers} == set(Ej._verifiers) == \
        {(CHUNK, 64, 4), (CHUNK, 256, 4)}
    a, b = TE._verifiers.values()
    assert a is not b
    assert a.stats == b.stats and a.stats["generic_sigs"] == 1


def test_verify_entry_metrics_equal_the_references(pair, monkeypatch):
    """The five accel.ed25519.* metrics, each side on a fresh registry of
    its own package: one mixed batch (two keys reach the hot threshold in
    it, six stay cold, three signatures fail the prep), then a batch of
    cold keys alone."""
    from stellar_core_tpu.util import metrics as r_metrics
    from stellar_core_tpu_torch.util import metrics as p_metrics
    ref, port = pair
    regs = r_metrics.MetricsRegistry(), p_metrics.MetricsRegistry()
    monkeypatch.setattr(Ej, "_registry", lambda: regs[0])
    monkeypatch.setattr(TE, "_registry", lambda: regs[1])
    rng = random.Random(52)
    thr = port.hot_threshold
    cases = []
    for _ in range(2):
        pk, sk = _keypair(rng)
        for i in range(thr + 1):
            cases.append((pk, sodium.sign_detached(bytes([i]) * 7, sk),
                          bytes([i]) * 7))
    for i in range(6):
        pk, sk = _keypair(rng)
        cases.append((pk, sodium.sign_detached(b"cold", sk), b"cold"))
    pk, sk = _keypair(rng)
    sig = sodium.sign_detached(b"r", sk)
    s_plus_l = (int.from_bytes(sig[32:], "little") + L).to_bytes(32, "little")
    cases += [(pk, sig[:32] + s_plus_l, b"r"),                # S not canonical
              (pk, bytes(32) + sig[32:], b"r"),               # R small order
              (pk, sig[:63], b"r")]                           # wrong length
    rng.shuffle(cases)
    # then three fresh keys, each under a signature made by another key
    strangers = [(_keypair(rng)[0], sig, b"r") for _ in range(3)]
    snaps = []
    for batch in (cases, strangers):
        _three_way(pair, batch)
        snaps.append((regs[0].snapshot(), regs[1].snapshot()))
    for want, got in snaps:
        assert got == want
    first, second = snaps[0][1], snaps[1][1]
    assert first["accel.ed25519.table-sigs"]["count"] == 2 * (thr + 1)
    assert first["accel.ed25519.generic-sigs"]["count"] == 6
    assert first["accel.ed25519.rejected-prep"]["count"] == 3
    assert first["accel.ed25519.tables-built"]["count"] == 2
    assert first["accel.ed25519.batch-size"]["count"] == 1
    assert second["accel.ed25519.generic-sigs"]["count"] == 9
    assert second["accel.ed25519.batch-size"]["max"] == len(cases)
