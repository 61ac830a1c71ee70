"""The port's native apply engine: its verify cache's misses, and the guard
that keeps it off where libsodium does not load.

The engine (native/capply.c) answers a signature check from a direct-mapped
cache of 2^18 slots, keyed by the low 18 bits of the first 8 bytes (read
little-endian) of SHA-256(pk || msg || sig).  A pair seeded later evicts
one seeded earlier into the same slot, so seeding never rules a miss out;
on a miss the engine verifies with libsodium itself.  Where libsodium does
not load, that verify is a rejection, so the port counts the engine as
available only where libsodium loads (ledger/native_apply.py).

* A real payment's signature, evicted from the seeded cache by a junk
  pair found to share its slot, is verified by the engine itself: the
  miss and libsodium-verify counters rise by one and the payment applies.
* With libsodium made to look absent, ``native_apply_available()`` and
  ``native_close_available()`` are False, the bridge refuses to start,
  ``attach_native_close()`` returns False and the chain closes in Python
  with the native run's hashes.
* Both packages build the same engine: the port's, loaded through its
  ``_native_build``, applies the chain of test_torch_ledger with the
  reference's hashes there.
"""

import hashlib
import os

import pytest

from stellar_core_tpu_torch import _native_build
from stellar_core_tpu_torch import xdr as X
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.ledger import native_apply, native_close
from stellar_core_tpu_torch.ledger.manager import LedgerManager
from stellar_core_tpu_torch.testutils import (TestAccount, create_account_op,
                                              native_payment_op, network_id)
from test_torch_ledger import CHAIN_LEDGERS, chain, chain_frames, _manager

SLOT_BITS = 18


@pytest.fixture
def engine():
    if not native_apply.native_apply_available():
        pytest.skip("the native engine did not build or libsodium does "
                    "not load")


def slot(pk: bytes, msg: bytes, sig: bytes) -> int:
    """The engine's cache slot of a pair (capply.c vcache_key/vcache_slot)."""
    d = hashlib.sha256(pk + msg + sig).digest()
    return int.from_bytes(d[:8], "little") & ((1 << SLOT_BITS) - 1)


def colliding_pair(target: int, seed: int = 0):
    """Random (pk, sig, msg) bytes whose slot is `target`: about 2^18
    hashes."""
    counter = seed
    while True:
        counter += 1
        pk = hashlib.sha256(b"pk" + counter.to_bytes(8, "little")).digest()
        msg = bytes(32)
        sig = pk + pk
        if slot(pk, msg, sig) == target:
            return pk, sig, msg


def test_slot_is_the_engines_key():
    assert slot(bytes(32), bytes(32), bytes(64)) == int.from_bytes(
        hashlib.sha256(bytes(128)).digest()[:8], "little") & 0x3FFFF
    pk, sig, msg = colliding_pair(12345)
    assert slot(pk, msg, sig) == 12345


def _payment_ledger():
    """A manager on native close with two funded accounts, and a signed
    payment between them (not yet closed) with its (pk, sig, msg)."""
    mgr = LedgerManager(network_id("torch engine misses"),
                        invariant_manager=None)
    mgr.start_new_ledger()
    assert mgr.attach_native_close()
    rsk = mgr.root_account_secret()
    e = mgr.root.get_entry(X.account_key_xdr(rsk.public_key.ed25519))
    top = TestAccount(mgr, rsk, e.data.value.seqNum)
    sks = [SecretKey(bytes([90 + i]) * 32) for i in range(2)]
    mgr.close_ledger([top.tx([create_account_op(
        X.AccountID.ed25519(sk.public_key.ed25519), 10 ** 10)
        for sk in sks])], 10)
    a = TestAccount(mgr, sks[0], mgr.root.get_entry(X.account_key_xdr(
        sks[0].public_key.ed25519)).data.value.seqNum)
    pay = a.tx([native_payment_op(
        X.AccountID.ed25519(sks[1].public_key.ed25519), 777)])
    pair = (sks[0].public_key.ed25519, pay.envelope.value.signatures[0].signature,
            pay.content_hash())
    return mgr, pay, pair


@pytest.mark.parametrize("evicted", [False, True],
                         ids=["seeded", "evicted-by-a-colliding-pair"])
def test_engine_verifies_a_seeded_signature_evicted_by_a_collision(
        engine, evicted):
    mgr, pay, (pk, sig, msg) = _payment_ledger()
    bridge = mgr.native_closer.bridge
    bridge.seed_verdicts([pk], [sig], [msg], [True])
    if evicted:
        junk = colliding_pair(slot(pk, msg, sig))
        assert junk != (pk, sig, msg)
        bridge.seed_verdicts([junk[0]], [junk[1]], [junk[2]], [False])
    before = bridge.stats()
    arts = mgr.close_ledger([pay], 20)
    after = bridge.stats()
    res = arts.result_entry.txResultSet.results[0].result.result
    assert res.switch == X.TransactionResultCode.txSUCCESS
    grew = {k: after[k] - before[k] for k in
            ("verify_cache_hits", "verify_cache_misses", "libsodium_verifies")}
    # the engine checks the signature twice in a close (validity, then
    # apply): both hit where it stayed seeded; evicted, the first check
    # misses and verifies with libsodium, which refills the slot
    assert grew == {"verify_cache_hits": 2 - evicted,
                    "verify_cache_misses": int(evicted),
                    "libsodium_verifies": int(evicted)}


def test_engine_off_where_libsodium_does_not_load(monkeypatch):
    assert native_apply.SODIUM_NAMES[:2] == ("libsodium.so.23",
                                            "libsodium.so")
    monkeypatch.setattr(native_apply, "libsodium_loads", lambda: False)
    assert not native_apply.native_apply_available()
    mgr, top = _manager("stellar_core_tpu_torch", "torch chain net",
                        invariants=False)
    assert not native_close.native_close_available(mgr)
    with pytest.raises(RuntimeError, match="libsodium"):
        native_apply.NativeApplyBridge(mgr.network_id)
    assert mgr.attach_native_close() is False
    assert mgr.native_closer is None
    hashes = []
    ledgers, _ = chain_frames("stellar_core_tpu_torch", mgr, top)
    for t, frames in enumerate(ledgers):
        arts = mgr.close_ledger(frames, 1_600_000_000 + 5 * t)
        hashes.append((mgr.lcl_header.ledgerSeq, mgr.lcl_hash,
                       arts.result_entry.txResultSet.to_xdr(),
                       mgr.bucket_list.hash()))
    assert len(hashes) == CHAIN_LEDGERS + 2
    monkeypatch.undo()
    if native_apply.native_apply_available():
        native, _ = chain("stellar_core_tpu_torch", invariants=False,
                          native=True)
        # the ledger hash commits to the header's bucket list hash; the
        # Python bucket list of a native close is rebuilt only at
        # checkpoint boundaries, so its own hash is left out
        assert [r[:3] for r in native[:-1]] == [r[:3] for r in hashes]


def test_libsodium_probe_reads_the_engines_names(monkeypatch):
    """The probe loads what capply.c's load_sodium() loads: none of its
    names loading, or none exporting the verify, means no libsodium."""
    import ctypes
    native_apply.libsodium_loads.cache_clear()
    try:
        tried = []

        def cdll(name):
            tried.append(name)
            raise OSError(name)

        monkeypatch.setattr(ctypes, "CDLL", cdll)
        assert native_apply.libsodium_loads() is False
        assert tuple(tried) == native_apply.SODIUM_NAMES
        native_apply.libsodium_loads.cache_clear()
        monkeypatch.setattr(ctypes, "CDLL", lambda name: object())
        assert native_apply.libsodium_loads() is False
    finally:
        native_apply.libsodium_loads.cache_clear()
        monkeypatch.undo()
    native_apply.libsodium_loads()


def test_capply_builds_into_the_ports_build_directory():
    assert _native_build.EXTENSIONS["_capply"] == "native/capply.c"
    so = _native_build.library_path("_capply")
    assert so.parent == _native_build.BUILD_DIR
    if native_apply._capply is not None:
        assert os.path.samefile(native_apply._capply.__file__, so)
        assert native_apply._capply.__name__ == \
            "stellar_core_tpu_torch._capply"
