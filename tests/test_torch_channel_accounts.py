"""Catchup of ledgers in which payment services submit through channel
accounts, by the port on its plain versions on the CPU, against the JAX
package's catchup and against the benchmark's frozen reference
(portbench/refcore), which made the archive.

The archive is portbench/lib/channels.py's at a small size: 200 ordinary
accounts, 2 services of 6 channels each, 4 payment ledgers of 24
transactions (every channel once, its base account paying, and 12
ordinary payments), every 7th transaction with one signature corrupted.
Each service transaction is signed by its channel's key and by its base
account's key, so the two base keys sign every ledger several times and
qualify for key tables (K-B + K-T) at the verifier's threshold of 4.

* CatchupManager at hot threshold 4 and at its default 1 << 62: every
  ledger's hash and every transaction's result is the reference's (a
  corrupted channel signature gives txBAD_AUTH, a corrupted base
  signature txFAILED); the tables run at 4 and not at the default; with
  fewer table slots than hot keys, the most used keys (the base
  accounts') hold them and the rest count as left on K-G;
* the JAX package's CatchupManager (its jitted programs on jax's CPU) and
  the port's, at 4 and at 1 << 62 with the race profile pinned in both:
  the same ledger hashes and transaction results, offload hit rate and
  pipeline counters, so the pairing of each operation's source account's
  signature with its signer is the JAX package's.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest

from portbench.lib import channels
from stellar_core_tpu.catchup import catchup as ref_catchup
from stellar_core_tpu.crypto import keys as ref_keys
from stellar_core_tpu.history.archive import FileHistoryArchive as RefArchive
from stellar_core_tpu.ledger.manager import LedgerManager as RefLedger
from stellar_core_tpu_torch.accel import ed25519 as TE
from stellar_core_tpu_torch.catchup import catchup as port_catchup
from stellar_core_tpu_torch.catchup.catchup import CatchupManager
from stellar_core_tpu_torch.crypto import keys as port_keys
from stellar_core_tpu_torch.history.archive import FileHistoryArchive
from stellar_core_tpu_torch.ledger.manager import LedgerManager
from stellar_core_tpu_torch.util import metrics

ROOT = Path(__file__).resolve().parent.parent
SEED = 2 ** 31 + 19
DEFAULT = 1 << 62


@pytest.fixture(autouse=True)
def _fresh_verifiers(monkeypatch):
    # each test starts from verifiers with no use counts and no tables
    from stellar_core_tpu.accel import ed25519 as ref_ed25519
    monkeypatch.setattr(TE, "_verifiers", {})
    monkeypatch.setattr(ref_ed25519, "_verifiers", {})


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    cfg = json.loads((ROOT / "portbench" / "configs" /
                      "catchup-channels.json").read_text())["archive"]
    cfg = copy.deepcopy(cfg)
    cfg.update(accounts=200, services=2, channels_per_service=6,
               txs_per_ledger=24, payment_ledgers=4, corrupt_every=7)
    return channels.generate(cfg, SEED,
                             str(tmp_path_factory.mktemp("channels")))


def _counters():
    return {name: m.value for name, m in metrics.registry().items()
            if isinstance(m, metrics.Counter)}


def _moved(before, name):
    return _counters().get(name, 0) - before.get(name, 0)


@pytest.fixture
def closes(monkeypatch):
    """{ledger: (hash, {tx hash: result code})} of the port's closes."""
    got = {}
    orig = LedgerManager.close_ledger

    def close_ledger(mgr, *args, **kw):
        arts = orig(mgr, *args, **kw)
        h = arts.header_entry
        got[h.header.ledgerSeq] = (h.hash, {
            p.transactionHash: p.result.result.switch.name
            for p in arts.result_entry.txResultSet.results})
        return arts
    monkeypatch.setattr(LedgerManager, "close_ledger", close_ledger)
    return got


def test_the_archive_holds_both_bad_co_signatures(archive):
    results = {h: c for seq in range(64, 68)
               for h, c in archive["ledgers"][seq]["results"].items()}
    assert len(results) == 4 * 24
    assert archive["bad_channel_txs"] and archive["bad_base_txs"]
    assert {results[h] for h in archive["bad_channel_txs"]} == {"txBAD_AUTH"}
    assert {results[h] for h in archive["bad_base_txs"]} == {"txFAILED"}
    assert archive["corrupted"] == 96 // 7
    # 12 channels, each co-signed by its base account, and 12 ordinary
    # payments a ledger
    assert archive["signatures"] - 4 == 4 * (2 * 12 + 12)


@pytest.mark.parametrize("threshold", [4, DEFAULT])
def test_catchup_gives_the_references_ledgers(archive, closes, threshold):
    first, last = archive["replay"]
    before = _counters()
    # the Python close, as on the card's machine (no libsodium there), so
    # that every close passes through the hooked close_ledger
    cm = CatchupManager(archive["nid"], archive["passphrase"], accel=True,
                        accel_device="cpu", accel_chunk=2048,
                        accel_hot_threshold=threshold, accel_profile="poll",
                        native=False)
    lm = cm.catchup_recent(FileHistoryArchive(archive["archive"]),
                           last - first + 1, to_ledger=last)
    assert lm.last_closed_ledger_seq == last
    for seq in range(first, last + 1):
        want = archive["ledgers"][seq]
        assert closes[seq] == (want["hash"], want["results"]), seq
    # every signature of the replay was paired and verified on the
    # device path: the apply verified none on the CPU
    assert _moved(before, "crypto.verify.recompute") == 0
    sigs = 4 * (2 * 12 + 12)
    table = _moved(before, "accel.ed25519.table-sigs")
    assert table + _moved(before, "accel.ed25519.generic-sigs") == sigs
    if threshold == DEFAULT:
        assert table == 0
        assert _moved(before, "accel.ed25519.tables-built") == 0
    else:
        # both base keys and every channel (4 uses in the one group)
        assert table >= 4 * 2 * 12
        assert _moved(before, "accel.ed25519.tables-built") >= 2 + 12


@pytest.fixture
def race_in_both(monkeypatch):
    """The race profile with a budget no group misses, pinned in both
    packages as tests/test_torch_catchup.py pins it: each collect waits
    for its group, so the pipelines' counters are exact."""
    for mod in (ref_catchup, port_catchup):
        pipe = mod.PreverifyPipeline
        monkeypatch.setattr(pipe, "DEFAULT_PROFILE", pipe.PROFILE_RACE)
        monkeypatch.setattr(pipe, "RACE_CPU_S_PER_SIG", float("inf"))
        monkeypatch.setattr(pipe, "COLLECT_TIMEOUT_S", 1800.0)


def _replay_by(root, archive, threshold):
    """({ledger: (hash, {tx hash: result code})}, CatchupManager) of one
    catchup of the payment ledgers by `root`'s package, on the Python
    close, the verify cache cleared first."""
    if root == "ref":
        mod, keys, Archive, Ledger, kw = (ref_catchup, ref_keys, RefArchive,
                                          RefLedger, {})
    else:
        mod, keys, Archive, Ledger, kw = (port_catchup, port_keys,
                                          FileHistoryArchive, LedgerManager,
                                          {"accel_device": "cpu"})
    first, last = archive["replay"]
    keys.clear_verify_cache()
    got = {}
    orig = Ledger.close_ledger

    def close_ledger(mgr, *args, **kw):
        arts = orig(mgr, *args, **kw)
        h = arts.header_entry
        got[h.header.ledgerSeq] = (h.hash, {
            p.transactionHash: p.result.result.switch.name
            for p in arts.result_entry.txResultSet.results})
        return arts

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Ledger, "close_ledger", close_ledger)
        cm = mod.CatchupManager(archive["nid"], archive["passphrase"],
                                accel=True, accel_chunk=256,
                                accel_hot_threshold=threshold, native=False,
                                **kw)
        lm = cm.catchup_recent(Archive(archive["archive"]),
                               last - first + 1, to_ledger=last)
    assert lm.last_closed_ledger_seq == last
    return got, cm


@pytest.mark.parametrize("threshold", [4, DEFAULT], ids=["K-B+K-T", "K-G"])
def test_catchup_gives_the_jax_packages_ledgers(archive, race_in_both,
                                                threshold):
    """The port on its plain versions and the JAX package on jax's CPU
    replay the same archive: every ledger's hash and transaction result,
    the offload hit rate and the pipeline's counters agree (every
    signature paired with its signer, an operation source's included, and
    shipped; the corrupted ones rejected)."""
    first, last = archive["replay"]
    port, pcm = _replay_by("port", archive, threshold)
    ref, rcm = _replay_by("ref", archive, threshold)
    for seq in range(first, last + 1):
        want = archive["ledgers"][seq]
        assert port[seq] == ref[seq] == (want["hash"], want["results"]), seq
    assert pcm.offload_hit_rate() == rcm.offload_hit_rate() == 1.0
    counts = lambda stats: {k: v for k, v in stats.items()
                            if not isinstance(v, float)}
    assert counts(pcm.stats) == counts(rcm.stats)
    assert pcm.stats["sigs_total"] >= 4 * (2 * 12 + 12)
    verifier = TE._verifier_for(256, 256, threshold, "cpu")
    if threshold == 4:
        assert verifier.stats["table_sigs"] >= 4 * 2 * 12
    else:
        assert verifier.stats["table_sigs"] == 0


def test_short_of_slots_the_base_keys_hold_tables(archive, closes):
    """Four table slots for 14 hot keys (2 base, 12 channels): the two base
    keys, the most used, and the two channel keys first by their bytes
    take the slots; the other hot keys' signatures count in
    accel.ed25519.hot-no-slot; every result is still the reference's."""
    first, last = archive["replay"]
    v = TE.Ed25519BatchVerifier(2048, table_slots=4, hot_threshold=4,
                                device="cpu")
    TE._verifiers[(2048, 2048, 4, TE.resolve_shards("cpu", None))] = v
    before = _counters()
    cm = CatchupManager(archive["nid"], archive["passphrase"], accel=True,
                        accel_device="cpu", accel_chunk=2048,
                        accel_hot_threshold=4, accel_profile="poll",
                        native=False)
    cm.catchup_recent(FileHistoryArchive(archive["archive"]),
                      last - first + 1, to_ledger=last)
    for seq in range(first, last + 1):
        want = archive["ledgers"][seq]
        assert closes[seq] == (want["hash"], want["results"]), seq
    counts = v._use_counts
    ranked = sorted((pk for pk, n in counts.items() if n >= 4),
                    key=lambda pk: (-counts[pk], pk))
    assert len(ranked) >= 14
    # the base keys sign every service transaction: 4 ledgers x 6
    assert [counts[pk] for pk in ranked[:2]] == [24, 24]
    assert set(v._tables.slot_of) == set(ranked[:4])
    left = _moved(before, "accel.ed25519.hot-no-slot")
    assert left >= 4 * (len(ranked) - 4)
    assert _moved(before, "accel.ed25519.table-sigs") \
        == v.stats["table_sigs"] >= 2 * 24 + 2 * 4 - 4
