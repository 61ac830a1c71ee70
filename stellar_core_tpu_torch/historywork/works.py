"""Historywork: Work units for archive I/O and catchup.

Reference: src/historywork/{GetAndUnzipRemoteFileWork, BatchDownloadWork,
VerifyLedgerChainWork}.cpp and src/catchup/{CatchupWork,
DownloadApplyTxsWork, ApplyCheckpointWork}.cpp — catchup as a DAG of
retryable work units, with checkpoint k+1's download/verify overlapping
checkpoint k's apply (double-buffering, SURVEY.md §5.8).  The card's
pre-verify is double-buffered the same way: as soon as a checkpoint's
download completes, its signature batch is DISPATCHED (async, no device
sync) while earlier checkpoints still apply; the verdicts are collected
only when that checkpoint's own apply starts.  Small checkpoints are
coalesced into one device batch (a dispatch's fixed cost is amortized
over more signatures).  Signer pairing against the
then-current ledger state stays exact because SetOptions-added signers are
harvested cumulatively across dispatched checkpoints
(catchup.PreverifyPipeline).

The archive reads are synchronous file IO here (no subprocess curl), but
the unit boundaries, retry semantics and pipelining match the reference's
shape: a failed download/verify retries with backoff without restarting
the whole catchup; apply is strictly sequential and cooperative (a few
ledgers per crank) so downloads interleave on the same clock.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .. import xdr as X
from ..catchup.catchup import (CatchupError, PreverifyPipeline,
                               verify_ledger_chain)
from ..crypto.sha import sha256
from ..history.archive import (CATEGORY_LEDGER, CATEGORY_TRANSACTIONS,
                               FileHistoryArchive, category_path,
                               checkpoint_containing, checkpoint_frequency)
from ..transactions.frame import TransactionFrame
import time

from ..util import eventlog
from ..util import logging as slog
from ..util import perf
from ..util import tracing
from ..util.clock import VirtualClock
from ..util.metrics import registry as _registry
from ..work.work import (RETRY_A_FEW, RETRY_NEVER, BasicWork, State, Work)

# checkpoint downloads are slow by nature — the 1s LogSlowExecution
# default would warn on every archive fetch (per-name override surface:
# util.perf.set_slow_threshold)
perf.set_slow_threshold("catchup.download.checkpoint", 30.0)

log = slog.get("History")

_LHHE = X.LedgerHeaderHistoryEntry._xdr_adapter()
_THE = X.TransactionHistoryEntry._xdr_adapter()


class GetAndVerifyCheckpointWork(BasicWork):
    """Download one checkpoint's ledger + transactions files and verify the
    header hash chain.  Retries with backoff on missing/corrupt data
    (reference: BatchDownloadWork unit + VerifyLedgerChainWork merged per
    checkpoint).

    When `network_id` is given, every envelope is also decoded into a
    TransactionFrame here, ONCE — both the accel pre-verify dispatch and
    the apply consume these same frames (the frame memoizes its
    content_hash), instead of each re-decoding the whole stream."""

    def __init__(self, clock: VirtualClock, archive: FileHistoryArchive,
                 checkpoint: int, network_id: Optional[bytes] = None,
                 decode_txs: bool = True, keep_raw: bool = False):
        """decode_txs=False keeps the transaction records RAW (for the
        native apply engine, which parses them itself; each record is
        strict-scanned by the C parser at download so corrupt archives
        keep their retry-with-backoff contract) — the decoded txs/frames
        views are then built lazily by ensure_decoded() on the
        Python-fallback path only.  keep_raw retains the raw records even
        when decoding (the accel+native path needs both)."""
        super().__init__(clock, f"get-verify-{checkpoint:08x}",
                         max_retries=RETRY_A_FEW)
        self.archive = archive
        self.checkpoint = checkpoint
        self.network_id = network_id
        self.decode_txs = decode_txs
        self.keep_raw = keep_raw or not decode_txs
        self.headers: List[X.LedgerHeaderHistoryEntry] = []
        self.raw_headers: List[bytes] = []
        self.raw_txs: Dict[int, bytes] = {}
        self.txs: Dict[int, X.TransactionHistoryEntry] = {}
        self.frames: Dict[int, List[TransactionFrame]] = {}

    def on_reset(self) -> None:
        self.headers = []
        self.raw_headers = []
        self.raw_txs = {}
        self.txs = {}
        self.frames = {}

    def ensure_decoded(self) -> None:
        """Decode any raw tx records not yet decoded (the download may have
        decoded only the scan-rejected ones) — the Python-fallback apply
        path and the accel pairing need objects."""
        for seq, raw in self.raw_txs.items():
            if seq not in self.txs:
                self.txs[seq] = _THE.unpack(raw)
            if self.network_id is not None and seq not in self.frames:
                self.frames[seq] = [
                    TransactionFrame.make_from_wire(self.network_id, env)
                    for env in self.txs[seq].txSet.txs]

    def all_frames(self) -> List[TransactionFrame]:
        """Every decoded frame of the checkpoint in ledger order (the
        pre-verify dispatch batch)."""
        out: List[TransactionFrame] = []
        for seq in sorted(self.frames):
            out.extend(self.frames[seq])
        return out

    def on_run(self) -> State:
        with tracing.span("catchup.download", checkpoint=self.checkpoint), \
                perf.scoped_timer("catchup.download.checkpoint"):
            return self._download_and_verify()

    def _download_and_verify(self) -> State:
        try:
            recs = self.archive.get_xdr_file(
                category_path(CATEGORY_LEDGER, self.checkpoint))
            if recs is None:
                log.warning("%s: ledger file missing", self.name)
                return State.FAILURE
            headers = [_LHHE.unpack(r) for r in recs]
            verify_ledger_chain(headers)
            raw_txs: Dict[int, bytes] = {}
            txs: Dict[int, X.TransactionHistoryEntry] = {}
            frames: Dict[int, List[TransactionFrame]] = {}
            scan = None
            if not self.decode_txs and self.network_id is not None:
                try:
                    from .. import _native_build
                    _capply = _native_build.load("_capply")
                    scan = _capply.scan_tx_record
                    scan_err = _capply.Error
                except ImportError:
                    pass
            for r in self.archive.get_xdr_file(
                    category_path(CATEGORY_TRANSACTIONS,
                                  self.checkpoint)) or []:
                # TransactionHistoryEntry leads with its u32 ledgerSeq
                if len(r) < 4:
                    raise CatchupError("truncated tx record")
                if self.keep_raw:
                    raw_txs[int.from_bytes(r[:4], "big")] = r
                if self.decode_txs:
                    e = _THE.unpack(r)
                    txs[e.ledgerSeq] = e
                    if self.network_id is not None:
                        frames[e.ledgerSeq] = [
                            TransactionFrame.make_from_wire(
                                self.network_id, env)
                            for env in e.txSet.txs]
                elif scan is not None:
                    try:
                        rc, _ = scan(self.network_id, r)
                    except scan_err as exc:
                        raise CatchupError(str(exc)) from exc
                    if rc != 0:
                        # well-formed but outside the native set: decode
                        # NOW (strict, retryable) so the fallback apply
                        # never hits a first-time decode error
                        e = _THE.unpack(r)
                        txs[e.ledgerSeq] = e
        except (X.XdrError, CatchupError, ValueError, OSError) as e:
            # corrupt OR hostile archive data (bad gzip, truncated record
            # mark/body, inflate-cap bomb, XDR decode failure): retry with
            # backoff, then the catchup fails with a localized error
            log.warning("%s: %s", self.name, e)
            return State.FAILURE
        self.headers = headers
        self.raw_headers = recs
        self.raw_txs = raw_txs
        self.txs = txs
        self.frames = frames
        return State.SUCCESS


class ApplyCheckpointWork(BasicWork):
    """Apply one downloaded checkpoint's ledgers, a few per crank
    (cooperative — downloads for later checkpoints interleave).  With
    accel, the checkpoint's signature verdicts were dispatched earlier by
    CatchupWork (possibly coalesced with neighbours); the first crank only
    COLLECTS them — by then the device has had the previous checkpoints'
    apply time to compute (reference: ApplyCheckpointWork; the async
    collect is the card's double-buffering seam)."""

    LEDGERS_PER_CRANK = 8

    def __init__(self, clock: VirtualClock, mgr,
                 download: GetAndVerifyCheckpointWork, target: int,
                 network_id: bytes,
                 pipeline: Optional[PreverifyPipeline] = None,
                 wait_last: bool = False):
        super().__init__(clock, f"apply-{download.checkpoint:08x}",
                         max_retries=RETRY_NEVER)
        self.mgr = mgr
        self.download = download
        self.target = target
        self.network_id = network_id
        self.pipeline = pipeline
        self.wait_last = wait_last
        self._idx = 0
        self._preverified = False
        self._native_rejected = False
        self._t_first_crank: Optional[float] = None
        self.error_detail = None

    def _fail(self, detail: str) -> State:
        self.error_detail = detail
        log.error("%s: %s", self.name, detail)
        return State.FAILURE

    def _run_native(self, bridge) -> Optional[State]:
        """Apply the whole checkpoint through the native engine.  Returns
        the work State, or None to fall back to the Python path (probe
        rejected — unsupported tx shapes in this checkpoint)."""
        mgr = self.mgr
        headers = self.download.headers
        raw_headers = self.download.raw_headers
        raw_txs = self.download.raw_txs
        # pending rows only (resume semantics mirror the Python loop)
        rows = [(entry, raw_headers[i])
                for i, entry in enumerate(headers)
                if entry.header.ledgerSeq > mgr.last_closed_ledger_seq]
        rows = [rw for rw in rows if rw[0].header.ledgerSeq <= self.target]
        if not rows:
            return State.SUCCESS
        tx_recs = [raw_txs.get(e.header.ledgerSeq) for e, _ in rows]
        if not bridge.probe(tx_recs):
            # fallback forfeit accounting: every checkpoint that leaves
            # the native engine gives up its ~3x apply rate — make a
            # silent regression visible in stats
            bridge.fallback_checkpoints += 1
            _registry().meter("catchup.native.fallback").mark()
            if bridge.active:
                bridge.export_to_manager(mgr)
            try:
                self.download.ensure_decoded()
            except Exception as e:
                return self._fail(f"tx decode failed on fallback: {e}")
            if self.pipeline is not None:
                # honest hit-rate denominator: the raw extraction did not
                # count records the C parser rejected — re-count this
                # checkpoint from the decoded frames
                python_total = sum(
                    len(f.signatures)
                    for frames in self.download.frames.values()
                    for f in frames)
                self.pipeline.correct_total_for_fallback(
                    self.download.checkpoint, python_total)
            return None
        if not bridge.active:
            bridge.import_from(mgr)
        try:
            bridge.apply_checkpoint([raw for _, raw in rows], tx_recs,
                                    self.target)
        except Exception as e:
            return self._fail(f"native apply failed: {e}")
        bridge.native_checkpoints += 1
        _registry().meter("catchup.native.checkpoint").mark()
        _registry().meter("catchup.apply.ledger").mark(len(rows))
        # bookkeeping: the manager's LCL view advances with the engine
        # (full state stays in C until export); the engine verified these
        # hashes against its own serialization fail-stop
        # the engine verified every applied header hash against its own
        # serialization (fail-stop in close_one_ledger); mirror its LCL
        seq, lcl_hash = bridge.lcl()
        tail = next(e for e, _ in reversed(rows)
                    if e.header.ledgerSeq == seq)
        mgr.lcl_header = tail.header
        mgr.lcl_hash = lcl_hash
        return State.SUCCESS

    def _checkpoint_frames(self) -> List[TransactionFrame]:
        if self.download.frames or not self.download.txs:
            return self.download.all_frames()
        # download ran without a network id: decode here, ONCE — store back
        # on the download so the apply loop below reuses these same frames
        for seq, the in self.download.txs.items():
            self.download.frames[seq] = [
                TransactionFrame.make_from_wire(self.network_id, env)
                for env in the.txSet.txs]
        return self.download.all_frames()

    def on_run(self) -> State:
        if self._t_first_crank is None:
            self._t_first_crank = time.perf_counter()
        with tracing.span("catchup.apply-checkpoint",
                          checkpoint=self.download.checkpoint):
            state = self._run_crank()
        if state == State.SUCCESS:
            # wall-clock from first crank to completion — includes the
            # preverify collect and any cooperative-yield gaps, which is
            # the honest per-checkpoint apply latency
            dur_s = time.perf_counter() - self._t_first_crank
            _registry().timer("catchup.apply.checkpoint").update(dur_s)
            # checkpoint verdict: one flight event per checkpoint keeps
            # post-mortems cheap even on thousand-checkpoint replays
            eventlog.record("History", "INFO", "checkpoint applied",
                            checkpoint=self.download.checkpoint,
                            lcl=self.mgr.last_closed_ledger_seq,
                            dur_ms=round(dur_s * 1e3, 1))
            tracing.mark_phase("checkpoint-apply",
                               self.download.checkpoint,
                               lcl=self.mgr.last_closed_ledger_seq,
                               dur_ms=round(dur_s * 1e3, 1))
        elif state == State.FAILURE:
            eventlog.record("History", "ERROR", "checkpoint apply FAILED",
                            checkpoint=self.download.checkpoint,
                            detail=self.error_detail or "?")
        return state

    def _run_crank(self) -> State:
        mgr = self.mgr
        headers = self.download.headers
        if self.pipeline is not None and not self._preverified:
            self._preverified = True
            cp = self.download.checkpoint
            if not self.pipeline.dispatched(cp):
                # CatchupWork dispatches ahead; this is the standalone /
                # degenerate path (e.g. the work used outside CatchupWork)
                if self.pipeline.pair_extractor is not None:
                    self.pipeline.dispatch_raw(
                        {cp: [self.download.raw_txs[seq]
                              for seq in sorted(self.download.raw_txs)]})
                else:
                    self.pipeline.dispatch({cp: self._checkpoint_frames()},
                                           ledger_state=mgr.root)
            try:
                # the target's checkpoint is the replay's last collect
                self.pipeline.collect(
                    cp, last=self.wait_last
                    and cp == checkpoint_containing(self.target))
            except CatchupError as e:
                # a device job failed on the card: no CPU fallback
                return self._fail(str(e))
            return State.RUNNING
        bridge = getattr(mgr, "native_bridge", None)
        if bridge is not None and not self._native_rejected:
            state = self._run_native(bridge)
            if state is not None:
                return state
            # probe rejected the checkpoint (memoized): state was exported
            # back to the Python manager; the oracle path below applies
            # this checkpoint on every subsequent crank
            self._native_rejected = True
        applied = 0
        while self._idx < len(headers) and applied < self.LEDGERS_PER_CRANK:
            entry = headers[self._idx]
            seq = entry.header.ledgerSeq
            if seq <= mgr.last_closed_ledger_seq:
                self._idx += 1
                continue
            if seq > self.target:
                return State.SUCCESS
            if seq != mgr.last_closed_ledger_seq + 1:
                return self._fail(f"gap in headers at {seq}")
            the = self.download.txs.get(seq)
            tx_set = the.txSet if the is not None else X.TransactionSet(
                previousLedgerHash=mgr.lcl_hash, txs=[])
            if sha256(tx_set.to_xdr()) != entry.header.scpValue.txSetHash:
                return self._fail(f"tx set hash mismatch at ledger {seq}")
            # frames were decoded once at download (and already carried the
            # accel pre-verify batch); re-decode only on the degenerate
            # standalone path where the download ran without a network id
            frames = self.download.frames.get(seq)
            if frames is None:
                frames = [TransactionFrame.make_from_wire(
                    self.network_id, env) for env in tx_set.txs]
            try:
                mgr.close_ledger(frames, entry.header.scpValue.closeTime,
                                 tx_set=tx_set,
                                 expected_ledger_hash=entry.hash,
                                 stellar_value=entry.header.scpValue)
            except Exception as e:
                return self._fail(f"apply failed at ledger {seq}: {e}")
            _registry().meter("catchup.apply.ledger").mark()
            self._idx += 1
            applied += 1
        if self._idx >= len(headers) \
                or mgr.last_closed_ledger_seq >= self.target:
            return State.SUCCESS
        return State.RUNNING


class CatchupWork(Work):
    """Pipelined complete-replay catchup: downloads run `lookahead`
    checkpoints ahead of the sequential apply cursor (reference:
    CatchupWork + DownloadApplyTxsWork's download-ahead of one checkpoint
    while the previous applies).  With accel, completed downloads are
    additionally PRE-DISPATCHED to the device in checkpoint order —
    coalescing up to 2*`coalesce` checkpoints per device batch once
    `coalesce` are ready, or immediately when the apply cursor is about to
    need them — so device compute overlaps host apply (SURVEY §5.8).

    `wait_last` lets the collect of the target's checkpoint wait for its
    device group (PreverifyPipeline.collect's `last`).  Only a replay that
    owns its clock sets it (CatchupManager: the catchup commands and the
    range workers); a running node's archive catchup shares the node's
    crank loop and, as the reference's, never waits."""

    def __init__(self, clock: VirtualClock, mgr, archive: FileHistoryArchive,
                 target: int, network_id: bytes, accel: bool = False,
                 accel_chunk: int = 8192, lookahead: int = 2,
                 stats: Optional[dict] = None, coalesce: int = 4,
                 accel_hot_threshold: int = 1 << 62,
                 decode_txs: bool = True, keep_raw: bool = False,
                 verdict_sink=None, pair_extractor=None,
                 accel_profile: Optional[str] = None,
                 checkpoint_hook=None, accel_device=None,
                 accel_devices=None, wait_last: bool = False):
        super().__init__(clock, "catchup", max_retries=RETRY_NEVER)
        self.mgr = mgr
        self.wait_last = wait_last
        self.archive = archive
        self.target = target
        self.network_id = network_id
        self.accel = accel
        self.decode_txs = decode_txs
        self.keep_raw = keep_raw
        self.verdict_sink = verdict_sink
        self.accel_chunk = accel_chunk
        self.coalesce = max(1, coalesce)
        # after every applied checkpoint: checkpoint_hook(lcl) may return
        # a LOWER published boundary to truncate the target mid-replay —
        # the work-stealing seam (a range worker that accepted a steal
        # limit stops at the split boundary; catchup/parallel.py)
        self.checkpoint_hook = checkpoint_hook
        self.pipeline = (PreverifyPipeline(network_id, accel_chunk,
                                           stats if stats is not None
                                           else {},
                                           hot_threshold=accel_hot_threshold,
                                           verdict_sink=verdict_sink,
                                           pair_extractor=pair_extractor,
                                           profile=accel_profile,
                                           device=accel_device,
                                           devices=accel_devices)
                         if accel else None)
        # poll/sig-only profiles auto-tune the coalesce depth against the
        # measured consumer rate (PreverifyPipeline.recommended_coalesce)
        self.auto_coalesce = (self.pipeline is not None
                              and self.pipeline.profile
                              != PreverifyPipeline.PROFILE_RACE)
        # the download window must run ahead of the dispatch groups for
        # coalescing to ever trigger (sized for the auto-tune's ceiling)
        max_coalesce = (PreverifyPipeline.MAX_COALESCE if self.auto_coalesce
                        else self.coalesce)
        self.lookahead = max(1, lookahead,
                             2 * max_coalesce if accel else 0)
        self.stats = self.pipeline.stats if self.pipeline is not None \
            else (stats if stats is not None else {})
        self._downloads: Dict[int, GetAndVerifyCheckpointWork] = {}
        self._apply: Optional[ApplyCheckpointWork] = None
        self._apply_checkpoint = 0
        self._next_dispatch = 0
        self._prev_tail: Optional[X.LedgerHeaderHistoryEntry] = None
        self.error_detail = None

    def on_reset(self) -> None:
        super().on_reset()
        self._downloads = {}
        self._apply = None
        # resume from wherever the manager already is: complete catchup
        # starts at genesis's checkpoint, CATCHUP_RECENT at the first
        # checkpoint past the assumed bucket state (CatchupRange)
        self._apply_checkpoint = checkpoint_containing(
            max(2, self.mgr.last_closed_ledger_seq + 1))
        self._next_dispatch = self._apply_checkpoint
        self._prev_tail = None

    def _close_pipeline(self) -> None:
        if self.pipeline is not None:
            self.pipeline.close()

    def on_failure_raise(self) -> None:
        self._close_pipeline()

    def on_aborted(self) -> None:
        self._close_pipeline()

    def _maybe_dispatch(self, last_cp: int) -> None:
        """Feed the device: walk completed, not-yet-dispatched downloads in
        checkpoint order (in-order dispatch keeps the cumulative SetOptions
        harvest a superset of every signer the apply will try) and enqueue
        them as one coalesced batch when enough are ready — or right away
        when the apply cursor is within one checkpoint of the group, where
        waiting would stall the pipeline."""
        ready = []
        c = self._next_dispatch
        while c <= last_cp:
            dl = self._downloads.get(c)
            if dl is None or not dl.done or dl.failed:
                break
            ready.append(c)
            c += checkpoint_frequency()
        if not ready:
            return
        urgent = ready[0] <= self._apply_checkpoint + checkpoint_frequency()
        if not urgent and len(ready) < self.coalesce:
            return
        # collect() blocks on a whole group's batch, so the group about to
        # be awaited must be SMALL (1 checkpoint) while the lookahead tail
        # coalesces into `coalesce`-sized batches that the device chews
        # through during earlier applies
        groups: List[List[int]] = []
        i = 0
        if urgent:
            groups.append(ready[:1])
            i = 1
        while i < len(ready):
            groups.append(ready[i:i + self.coalesce])
            i += self.coalesce
        for g in groups:
            if self.pipeline.pair_extractor is not None:
                self.pipeline.dispatch_raw(
                    {cp: [self._downloads[cp].raw_txs[seq]
                          for seq in sorted(self._downloads[cp].raw_txs)]
                     for cp in g})
            else:
                self.pipeline.dispatch(
                    {cp: self._downloads[cp].all_frames() for cp in g},
                    ledger_state=self.mgr.root)
        self._next_dispatch = ready[-1] + checkpoint_frequency()

    def on_run(self) -> State:
        if self.mgr.last_closed_ledger_seq >= self.target:
            self._close_pipeline()
            return State.SUCCESS
        if self.auto_coalesce:
            self.coalesce = self.pipeline.recommended_coalesce(self.coalesce)
        # keep the download window full (never past the target checkpoint)
        cp = self._apply_checkpoint
        last_cp = checkpoint_containing(self.target)
        for k in range(self.lookahead):
            c = cp + k * checkpoint_frequency()
            if c > last_cp:
                break
            if c not in self._downloads:
                w = GetAndVerifyCheckpointWork(self.clock, self.archive, c,
                                               network_id=self.network_id,
                                               decode_txs=self.decode_txs,
                                               keep_raw=self.keep_raw)
                self._downloads[c] = w
                self.add_work(w)
        if self.pipeline is not None:
            self._maybe_dispatch(last_cp)
        dl = self._downloads.get(cp)
        if dl is None or not dl.done:
            return State.WAITING
        if dl.failed:
            self.error_detail = f"checkpoint {cp} download unrecoverable"
            log.error("catchup: %s", self.error_detail)
            return State.FAILURE
        # cross-checkpoint chain continuity
        if self._apply is None:
            prev_hash = (self._prev_tail.hash if self._prev_tail is not None
                         else self.mgr.lcl_hash)  # assumed-state anchor
            if prev_hash is not None and dl.headers and \
                    dl.headers[0].header.ledgerSeq \
                    == self.mgr.last_closed_ledger_seq + 1 and \
                    dl.headers[0].header.previousLedgerHash != prev_hash:
                self.error_detail = f"chain broken across checkpoint {cp}"
                log.error("catchup: %s", self.error_detail)
                return State.FAILURE
            self._apply = ApplyCheckpointWork(
                self.clock, self.mgr, dl, self.target, self.network_id,
                pipeline=self.pipeline, wait_last=self.wait_last)
            self.add_work(self._apply)
            return State.WAITING
        if not self._apply.done:
            return State.WAITING
        if self._apply.failed:
            self.error_detail = self._apply.error_detail \
                or f"apply of checkpoint {cp} failed"
            return State.FAILURE
        if dl.headers:
            self._prev_tail = dl.headers[-1]
        del self._downloads[cp]
        self._apply = None
        self._apply_checkpoint = cp + checkpoint_frequency()
        if self.checkpoint_hook is not None:
            # work-stealing seam: the hook reports progress and may hand
            # back a lower published boundary (>= the LCL we just reached)
            # that truncates this replay — the stolen tail is someone
            # else's range now
            new_target = self.checkpoint_hook(self.mgr.last_closed_ledger_seq)
            if new_target is not None \
                    and self.mgr.last_closed_ledger_seq <= new_target \
                    < self.target:
                log.info("catchup target truncated %d -> %d (checkpoint "
                         "hook)", self.target, new_target)
                self.target = new_target
        if self.mgr.last_closed_ledger_seq >= self.target:
            self._close_pipeline()
            return State.SUCCESS
        return State.RUNNING
