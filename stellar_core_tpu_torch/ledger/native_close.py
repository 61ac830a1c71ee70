"""Native live close: LedgerManager.close_ledger driven by the C engine.

Reference: the reference node's single native apply path serves BOTH
catchup replay and live close (LedgerManagerImpl::applyLedger); this
module gives the framework the same property.  A NativeLedgerCloser owns a
NativeApplyBridge whose engine holds the authoritative ledger state;
every externalized tx set is serialized once and applied in C
(`Engine.close_ledger`), and the engine returns the new header, the
TransactionResultSet and the ledger's entry delta so the Python manager
mirrors its read view (tx-queue/admission sequence checks, /info, HTTP
endpoints keep working against `mgr.root`).

Differential guard subsystem:

- ``NATIVE_CLOSE_DIFFERENTIAL=N`` (config key or environment): every Nth
  close ALSO runs the pure-Python close on a scratch manager built from
  the engine's exported state and fail-stops with a crash bundle on any
  divergence in per-tx results, fees, header hash or bucket hashes.  A
  divergence is a consensus-critical engine bug: the node must not keep
  closing ledgers with it.
- probe miss (a live tx set with non-classic content): that one close
  runs in Python after an export round-trip, then the engine re-imports
  — mirrored by the ``ledger.native.fallbacks`` meter.
- engine error: the engine rolls back the failed close, state is
  exported back to Python, the closer DEGRADES permanently (flight event
  + ``on_degrade`` status hook) and every later close runs in Python.

Durability while active: the Python bucket list is stale between
checkpoint boundaries; the closer rebuilds it (and persists, when a
database is attached) at every boundary and on deactivate, so history
publishing always sees fresh buckets.  A crash between boundaries is
re-covered by the same archive-rejoin path the fleet harness exercises.

Kill switch: STELLAR_TPU_NO_CAPPLY disables the whole subsystem.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

from .. import xdr as X
from ..crypto.sha import sha256
from ..util import eventlog
from ..util import logging as slog
from ..util import tracing
from ..util.metrics import registry as _registry
from .native_apply import NativeApplyBridge, native_apply_available

log = slog.get("Ledger")

ENV_DIFFERENTIAL = "NATIVE_CLOSE_DIFFERENTIAL"


def native_close_available(mgr) -> bool:
    """The native close path needs the extension, an in-memory root (the
    BucketListDB root reads bucket files the engine does not maintain
    per close) and no invariant manager (the invariant hooks live on the
    Python close path)."""
    return (native_apply_available()
            and mgr.bucket_store is None
            and mgr.invariants is None)


class NativeCloseDivergence(RuntimeError):
    """A differential spot-check caught the C engine disagreeing with the
    Python oracle — consensus-critical, always fail-stop."""


class NativeLedgerCloser:
    """Owns the engine that closes this manager's ledgers natively."""

    def __init__(self, mgr, differential: Optional[int] = None):
        if not native_close_available(mgr):
            raise RuntimeError("native close unavailable (extension not "
                               "built, disk root, or invariants enabled)")
        self.mgr = mgr
        if differential is None:
            differential = int(os.environ.get(ENV_DIFFERENTIAL, "0") or 0)
        self.differential = max(0, int(differential))
        self.bridge = NativeApplyBridge(mgr.network_id)
        self.degraded: Optional[str] = None
        self.closes = 0
        self.fallbacks = 0
        self.differential_checks = 0
        # wiring hooks (Application: status line + flight recorder)
        self.on_degrade = None          # callable(reason: str)
        # test seam: mutate the native result tuple before the
        # differential compare (forces a divergence end to end)
        self._corrupt_native_result_for_test = None

    # -- lifecycle ----------------------------------------------------------
    def activate(self) -> None:
        if not self.bridge.active:
            self.bridge.import_from(self.mgr)
        log.info("native live close active (differential=%d)",
                 self.differential)

    def deactivate(self) -> None:
        """Move authority back to Python (bucket list + root rebuilt)."""
        if self.bridge.active:
            self.bridge.export_to_manager(self.mgr)
            if self.mgr.db is not None:
                self.mgr._persist_lcl()

    # -- close --------------------------------------------------------------
    def close_ledger(self, frames: Sequence, close_time: int,
                     tx_set=None, stellar_value=None):
        """The LedgerManager.close_ledger native path.  Returns the same
        ClosedLedgerArtifacts as the Python close, or falls back to it
        (probe miss / degraded)."""
        mgr = self.mgr
        if self.degraded is not None or not self.bridge.active:
            return mgr._close_ledger_python(frames, close_time, tx_set,
                                            None, stellar_value)
        # Soroban content (generalized tx set / soroban frames / pending
        # TTL archival) is Python-only: the C engine neither hosts the
        # built-in table nor evicts expired entries — fall back EARLY,
        # before any TransactionHistoryEntry is built from a set shape
        # the legacy record cannot carry
        from ..soroban.txset import is_generalized
        if (tx_set is not None and is_generalized(tx_set)) \
                or any(f.is_soroban() for f in frames) \
                or mgr._ttl_expiry is None or mgr._ttl_expiry:
            return self._fallback_close(frames, close_time, tx_set,
                                        stellar_value,
                                        why="soroban content in the tx set")
        _t0 = time.perf_counter()
        if tx_set is None:
            tx_set, tx_set_hash, _ = mgr.make_tx_set(frames)
        else:
            tx_set_hash = sha256(tx_set.to_xdr())
        if stellar_value is None:
            stellar_value = X.StellarValue(txSetHash=tx_set_hash,
                                           closeTime=close_time)
        seq = mgr.lcl_header.ledgerSeq + 1
        tx_rec = X.TransactionHistoryEntry(ledgerSeq=seq,
                                           txSet=tx_set).to_xdr()
        if not self.bridge.probe([tx_rec]):
            # non-classic content in a LIVE tx set: close this one in
            # Python after an export round-trip, then resume native
            return self._fallback_close(frames, close_time, tx_set,
                                        stellar_value,
                                        why="probe rejected the tx set")
        scratch = None
        if self.differential and (self.closes + 1) % self.differential == 0:
            scratch = self._scratch_manager()
        # the ledger.close span covers ONLY the genuinely-native close;
        # every fallback route runs _close_ledger_python, which opens its
        # own span — nesting two ledger.close spans for one ledger would
        # double trace-derived close counts
        err = None
        with tracing.span("ledger.close",
                          seq=mgr.lcl_header.ledgerSeq + 1,
                          txs=len(frames)):
            try:
                # the whole tx phase runs in C: one batched tx.apply span
                # stands in for the Python path's per-tx spans
                with tracing.span("ledger.tx-apply"), \
                        tracing.span("tx.apply", txs=len(frames),
                                     engine="native"):
                    result = self.bridge.close_ledger(
                        tx_rec, self._scp_value_xdr(stellar_value))
            except Exception as e:  # corelint: disable=exception-hygiene -- any engine error degrades to the Python close (logged + flight event)
                err = e
            if err is None:
                if scratch is not None:
                    if self._corrupt_native_result_for_test is not None:
                        result = self._corrupt_native_result_for_test(result)
                    self._differential_check(scratch, frames, close_time,
                                             tx_set, stellar_value, result)
                return self._finish(result, tx_set, _t0)
        return self._degrade_close(frames, close_time, tx_set,
                                   stellar_value, err)

    # -- internals ----------------------------------------------------------
    @staticmethod
    def _scp_value_xdr(stellar_value) -> bytes:
        return stellar_value.to_xdr()

    def _finish(self, result, tx_set, t0: float):
        from .manager import ClosedLedgerArtifacts
        mgr = self.mgr
        seq, lcl_hash, header_xdr, results_xdr, delta = result
        header = X.LedgerHeader.from_xdr(header_xdr)
        result_set = X.TransactionResultSet.from_xdr(results_xdr)
        # mirror the ledger delta into the Python read view
        entries = {kb: (None if rec is None else X.LedgerEntry.from_xdr(rec))
                   for kb, rec in delta}
        mgr.root._apply_delta(entries, header)
        mgr.lcl_header = header
        mgr.lcl_hash = lcl_hash
        if mgr.db is not None:
            # per-ledger header rows feed checkpoint publishing; the
            # bucket files + durable LCL pointer follow at boundaries
            mgr.db.store_header(lcl_hash, header)
            mgr.db.commit()
        self.closes += 1
        reg = _registry()
        reg.meter("ledger.native.closes").mark()
        reg.meter("ledger.transaction.apply").mark(len(result_set.results))
        # injected-regression seam: same spin as the Python
        # close so anomaly proof tests work regardless of engine
        if mgr.debug_close_throttle_s > 0.0:  # corelint: disable=float-discipline -- test-only throttle knob, never ledger state
            _spin_until = time.perf_counter() + mgr.debug_close_throttle_s
            while time.perf_counter() < _spin_until:
                pass
        dur_s = time.perf_counter() - t0
        reg.timer("ledger.ledger.close").update(dur_s)
        # close cost record: phase splits and entry-cache
        # traffic are engine-internal on this path — 0 marks "not
        # attributable", total_s still carries the close cost
        mgr.close_costs.add(
            seq=seq, txs=len(result_set.results), total_s=dur_s,
            fee_s=0.0, apply_s=0.0, seal_s=0.0,  # corelint: disable=float-discipline -- cost-record "not attributable" sentinels, monitoring-only
            merge_stall_s=mgr.bucket_list.last_add_stall_s,
            cache_hits=0, cache_misses=0,
            pin_count=(mgr.bucket_store.pin_count()
                       if mgr.bucket_store is not None else 0),
            resident_entries=mgr.bucket_list.decoded_entry_count(),
            resident_delta=0,
            gc_backlog=(seq - mgr._last_gc_seq
                        if mgr.bucket_store is not None else 0))
        # same flight-event name as the Python close (post-mortem greps
        # key on it); the engine field tells the paths apart
        eventlog.record("Ledger", "INFO", "ledger close sealed",
                        seq=seq, txs=len(result_set.results),
                        dur_ms=round(dur_s * 1e3, 3),
                        hash=lcl_hash.hex()[:16], engine="native")
        tracing.mark_phase("close-seal", seq,
                           txs=len(result_set.results),
                           dur_ms=round(dur_s * 1e3, 3), engine="native")
        if self._at_boundary(seq):
            self._sync_boundary()
        if mgr.meta_stream is not None:
            mgr._emit_close_meta(
                X.LedgerHeaderHistoryEntry(hash=lcl_hash, header=header),
                tx_set, list(result_set.results))
        return ClosedLedgerArtifacts(
            header_entry=X.LedgerHeaderHistoryEntry(hash=lcl_hash,
                                                    header=header),
            tx_entry=X.TransactionHistoryEntry(ledgerSeq=seq, txSet=tx_set),
            result_entry=X.TransactionHistoryResultEntry(
                ledgerSeq=seq, txResultSet=result_set))

    def _at_boundary(self, seq: int) -> bool:
        from ..history.archive import is_checkpoint_boundary
        return is_checkpoint_boundary(seq)

    def _sync_boundary(self) -> None:
        """Checkpoint boundary: history publishing (and persistence) read
        the PYTHON bucket list — rebuild it from the engine."""
        self.bridge.sync_buckets_to(self.mgr)
        if self.mgr.db is not None:
            self.mgr._persist_lcl()

    def _scratch_manager(self):
        """A throwaway manager carrying a full copy of the engine state —
        the Python oracle closes on it during a differential check."""
        from .manager import LedgerManager
        scratch = LedgerManager(self.mgr.network_id, invariant_manager=None)
        scratch.start_new_ledger()
        self.bridge._export_into(scratch)
        return scratch

    def _differential_check(self, scratch, frames, close_time, tx_set,
                            stellar_value, result) -> None:
        seq, lcl_hash, header_xdr, results_xdr, _delta = result
        self.differential_checks += 1
        _registry().meter("ledger.native.differential-checks").mark()
        arts = scratch.close_ledger(frames, close_time, tx_set=tx_set,
                                    stellar_value=stellar_value)
        py_results = arts.result_entry.txResultSet
        ok = (scratch.lcl_hash == lcl_hash
              and scratch.lcl_header.to_xdr() == header_xdr
              and py_results.to_xdr() == results_xdr)
        if ok:
            return
        detail = self._divergence_detail(seq, py_results, results_xdr,
                                         scratch, lcl_hash)
        eventlog.write_crash_bundle(f"NativeCloseDivergence: {detail}")
        raise NativeCloseDivergence(detail)

    @staticmethod
    def _divergence_detail(seq, py_results, results_xdr, scratch,
                           lcl_hash) -> str:
        """Name the first diverging tx (and fee) so the crash bundle says
        which op went wrong, not just that hashes differ."""
        try:
            c_results = X.TransactionResultSet.from_xdr(results_xdr)
        except Exception:  # corelint: disable=exception-hygiene -- undecodable native bytes ARE the divergence being reported
            return (f"ledger {seq}: native result set undecodable; python "
                    f"lcl {scratch.lcl_hash.hex()[:16]} vs native "
                    f"{lcl_hash.hex()[:16]}")
        for i, (pp, cp) in enumerate(zip(py_results.results,
                                         c_results.results)):
            if pp.to_xdr() != cp.to_xdr():
                fee = (pp.result.feeCharged, cp.result.feeCharged)
                return (f"ledger {seq} tx #{i} "
                        f"{pp.transactionHash.hex()[:16]}: python result "
                        f"code {pp.result.result.switch} fee {fee[0]} vs "
                        f"native code {cp.result.result.switch} fee "
                        f"{fee[1]}")
        if len(py_results.results) != len(c_results.results):
            return (f"ledger {seq}: result counts diverge "
                    f"({len(py_results.results)} python vs "
                    f"{len(c_results.results)} native)")
        return (f"ledger {seq}: results identical but header/bucket state "
                f"diverged (python lcl {scratch.lcl_hash.hex()[:16]} vs "
                f"native {lcl_hash.hex()[:16]})")

    def _fallback_close(self, frames, close_time, tx_set, stellar_value,
                        why: str):
        """One Python close with a full export/import round-trip (probe
        miss on a live set — rare: Soroban or generalized-set content)."""
        mgr = self.mgr
        self.fallbacks += 1
        _registry().meter("ledger.native.fallbacks").mark()
        eventlog.record("Ledger", "WARNING", "native close fallback",
                        seq=mgr.lcl_header.ledgerSeq + 1, why=why)
        self.bridge.export_to_manager(mgr)
        arts = mgr._close_ledger_python(frames, close_time, tx_set, None,
                                        stellar_value)
        self.bridge.import_from(mgr)
        return arts

    def _degrade_close(self, frames, close_time, tx_set, stellar_value,
                       exc: Exception):
        """Engine error: permanent degrade to the Python engine.  The
        engine rolled the failed close back (or reports itself poisoned,
        in which case there is no state to recover — fail-stop)."""
        mgr = self.mgr
        reason = f"native close error at ledger " \
                 f"{mgr.lcl_header.ledgerSeq + 1}: {exc}"
        self.degraded = reason
        self.fallbacks += 1
        _registry().meter("ledger.native.fallbacks").mark()
        eventlog.record("Ledger", "ERROR", "native close DEGRADED",
                        reason=str(exc))
        log.error("native live close degraded to Python: %s", exc)
        if self.on_degrade is not None:
            try:
                self.on_degrade(reason)
            except Exception:  # corelint: disable=exception-hygiene -- status-line wiring is best-effort during a degrade
                pass
        try:
            self.bridge.export_to_manager(mgr)
        except Exception as export_exc:
            eventlog.write_crash_bundle(
                f"native close degrade failed: engine state unrecoverable "
                f"({export_exc}) after {exc}")
            raise
        return mgr._close_ledger_python(frames, close_time, tx_set, None,
                                        stellar_value)
