"""Catchup: bootstrap/resync a node from history archives.

Reference: src/catchup/CatchupWork.cpp (the work DAG root),
VerifyLedgerChainWork.cpp (back-chained previousLedgerHash verification),
ApplyBucketsWork.cpp + BucketApplicator (state snapshot assumption),
ApplyCheckpointWork.cpp (tx replay — THE north-star hot loop, SURVEY.md §3.3),
CatchupConfiguration (CATCHUP_COMPLETE vs minimal/recent modes).

Card offload hook: before a checkpoint replays, every (pk, sig, payload)
triple that can be paired by signature hint is batch-verified on the card
(accel.ed25519.verify_batch_async: the CUDA kernels K-G, or K-B + K-T for
hot keys) and the verdicts seeded into the process verify cache, so the
SignatureChecker inside TransactionFrame.apply hits the cache instead of
calling libsodium — observable behavior identical, compute hoisted
(BASELINE.json: "batches every envelope and transaction signature from a
catchup work-unit into a single vmapped Ed25519 verify").

The copy of stellar_core_tpu/catchup/catchup.py; what differs is where the
device work runs: `accel_device` / `accel_devices` (CatchupManager, and
PreverifyPipeline's `device` / `devices`) name the card or cards, None
meaning the card (and an error where there is none), "cpu" the plain
PyTorch versions of the kernels.  One difference in behaviour: under the
poll profile the collect of the replay's last checkpoint waits for its
group (PreverifyPipeline._wait_last_group), where the reference never
waits; no later collect could take those verdicts, and a replay of a
single checkpoint would otherwise verify all of it on the CPU.  Only
CatchupManager's replays wait there (they crank a clock of their own); a
running node's archive catchup (main.application) shares its crank loop
and does not.
"""

from __future__ import annotations

import atexit
import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .. import xdr as X
from ..bucket.bucket import Bucket
from ..bucket.bucket_list import NUM_LEVELS
from ..crypto import keys
from ..crypto.sha import sha256
from ..history.archive import (CATEGORY_LEDGER, CATEGORY_RESULTS,
                               CATEGORY_TRANSACTIONS, FileHistoryArchive,
                               category_path, checkpoint_containing,
                               checkpoint_frequency,
                               first_ledger_in_checkpoint)
from ..ledger.manager import LedgerManager
from ..transactions.frame import TransactionFrame
import itertools

from ..util import eventlog
from ..util import logging as slog
from ..util import tracing
from ..util.logging import discard_rate_limit, rate_limited
from ..util.metrics import registry as _registry
from ..util.racetrace import race_checked

log = slog.get("History")

_LHHE = X.LedgerHeaderHistoryEntry._xdr_adapter()
_THE = X.TransactionHistoryEntry._xdr_adapter()


class CatchupError(RuntimeError):
    pass


# monotone ids for per-pipeline rate-limit keys (GIL-atomic counter)
_PIPELINE_IDS = itertools.count(1)


class _DeviceCalls:
    """The verify calls in flight on pipelines' worker threads.  Torch
    aborts the process when the interpreter finalizes while a daemon thread
    is inside one of its operations, and a poll-profile catchup may end
    with a group still verifying; so at exit no new call starts and the
    ones in flight are waited for, up to EXIT_WAIT_S."""

    EXIT_WAIT_S = 120.0

    def __init__(self):
        self._cond = threading.Condition()
        self._running = 0
        self._exiting = False

    @contextlib.contextmanager
    def call(self):
        with self._cond:
            if self._exiting:
                raise CatchupError("interpreter exiting: no device call")
            self._running += 1
        try:
            yield
        finally:
            with self._cond:
                self._running -= 1
                self._cond.notify_all()

    def drain(self) -> None:
        with self._cond:
            self._exiting = True
            self._cond.wait_for(lambda: self._running == 0,
                                timeout=self.EXIT_WAIT_S)


_DEVICE_CALLS = _DeviceCalls()
atexit.register(_DEVICE_CALLS.drain)


def resolve_accel_devices(device, devices, default=None):
    """The devices a preverify pipeline verifies on: `devices`, else
    `device`, else `default` (PreverifyPipeline.DEFAULT_DEVICE), each as
    device.resolve_shards takes them — None is the card, and raises where
    CUDA is not available."""
    from ..device import resolve_shards
    if device is None and devices is None:
        device = default
    return resolve_shards(device, devices)


def verify_ledger_chain(headers: Sequence[X.LedgerHeaderHistoryEntry],
                        trusted_tail_hash: Optional[bytes] = None) -> None:
    """Each entry's hash must equal SHA256 of its header, and each header
    must chain to the previous entry's hash (reference:
    VerifyLedgerChainWork — verified back from a trusted hash)."""
    prev_hash: Optional[bytes] = None
    for entry in headers:
        if sha256(entry.header.to_xdr()) != entry.hash:
            raise CatchupError(
                f"header self-hash mismatch at ledger {entry.header.ledgerSeq}")
        if prev_hash is not None and entry.header.previousLedgerHash != prev_hash:
            raise CatchupError(
                f"hash chain broken at ledger {entry.header.ledgerSeq}")
        prev_hash = entry.hash
    if trusted_tail_hash is not None and headers \
            and headers[-1].hash != trusted_tail_hash:
        raise CatchupError("chain tail does not match trusted hash")


@race_checked
class PreverifyPipeline:
    """Double-buffered signature pre-verification on the card (SURVEY §5.8:
    dispatch checkpoint k+1's batch while the CPU applies checkpoint k;
    reference pipelining shape: src/catchup/ — DownloadApplyTxsWork).

    ``dispatch(groups, ledger_state)`` pairs every hint-pairable signature
    of one or more checkpoints and enqueues the device kernels WITHOUT
    syncing (accel verify_async); ``collect(checkpoint)`` seeds the
    verdicts of the group containing that checkpoint into the process
    verify cache.  Between the two calls the device computes while the
    host applies earlier ledgers.

    Device: `device` / `devices` as accel.ed25519.verify_batch_async takes
    them, resolved here on the constructing thread; with neither given, the
    class attribute DEFAULT_DEVICE, whose None is the card (raising where
    CUDA is not available: the pipeline never moves to the CPU on its own).
    Tests pin DEFAULT_DEVICE = "cpu" process-wide, as they pin
    DEFAULT_PROFILE.  On the card a device job that raises (a kernel that
    does not build or launch) fails the catchup with CatchupError at the
    collect or close that sees it (``raise_device_errors``); on the plain
    versions it falls back to CPU verification as the reference does.
    Only a group that is late (poll) or loses its race still verifies on
    the CPU.

    Offload profiles (the device may only ever ADD throughput):

    * ``poll`` (the default) — collect() is a NON-BLOCKING poll: every
      materialized group's verdicts are harvested and seeded on the spot,
      and a group whose verdicts have not materialized yet is simply
      skipped (the apply verifies those signatures on CPU via libsodium —
      verdicts identical, the device is never waited on).  A group that
      ripens later is still seeded at the next checkpoint's collect, so
      its remaining checkpoints hit the cache (``sigs_late_seeded``).
      The consumer's worst case is the CPU replay rate minus the (small,
      measured) pairing cost — the device cannot drag it below that.
    * ``race`` (opt-in; the earlier behavior) — collect() waits,
      bounded by what libsodium would charge for the group, and repeated
      losses/wedges disable the pipeline.  The admission pipeline keeps
      this profile: it needs the batch's verdicts to answer the submitter.
    * ``sig-only`` — like ``poll``, but the pipeline never disables
      itself: the device ships signature verdicts opportunistically for
      as long as the catchup runs and is never on the ledger-close
      critical path, however slow it is.

    Pairing candidates per signature: the tx/fee-bump/op source accounts'
    master keys, every ed25519 signer of those accounts in `ledger_state`
    (reference hint semantics: SignatureChecker::checkSignature tries every
    signer whose hint matches), plus every ed25519 signer harvested from
    SetOptions operations of ANY checkpoint dispatched so far — dispatching
    k+1 against pre-k state is exact as long as signers added between the
    state snapshot and the tx's ledger are harvested, and in-order dispatch
    guarantees that.  Hint collisions pair against every matching
    candidate; a wrong pairing just caches a negative verdict for a tuple
    nobody asks about.  Unpaired signatures fall back to on-demand CPU
    verification — verdicts never differ, only where they're computed.
    """

    # profile names (see class docstring); DEFAULT_PROFILE is a class
    # attribute so tests that need deterministic blocking collects can pin
    # the legacy profile process-wide
    PROFILE_POLL = "poll"
    PROFILE_RACE = "race"
    PROFILE_SIG_ONLY = "sig-only"
    DEFAULT_PROFILE = "poll"
    PROFILES = (PROFILE_POLL, PROFILE_RACE, PROFILE_SIG_ONLY)
    # the device of a pipeline built with neither `device` nor `devices`:
    # None is the card, "cpu" the plain versions
    DEFAULT_DEVICE = None

    def __init__(self, network_id: bytes, chunk_size: int = 2048,
                 stats: Optional[Dict[str, int]] = None,
                 hot_threshold: int = 1 << 62,
                 verdict_sink=None, pair_extractor=None,
                 profile: Optional[str] = None,
                 device=None, devices=None):
        self.network_id = network_id
        # resolved once, here: the worker thread must not resolve "the
        # current device" on its own (torch keeps it per thread)
        self.devices = resolve_accel_devices(device, devices,
                                             self.DEFAULT_DEVICE)
        # on the card a failed device job is a fault, not a lost race
        self.raise_device_errors = self.devices[0].type == "cuda"
        self.chunk_size = chunk_size
        self.profile = profile if profile is not None else self.DEFAULT_PROFILE
        if self.profile not in self.PROFILES:
            raise ValueError(f"unknown offload profile {self.profile!r} "
                             f"(know: {self.PROFILES})")
        # optional second consumer of collected verdicts (the native apply
        # engine's verify cache) alongside the process verify cache
        self.verdict_sink = verdict_sink
        # optional native pairing (bridge.extract_pairs): dispatch_raw
        # pairs straight from raw records, skipping Python frame decode
        self.pair_extractor = pair_extractor
        # per-key window tables on the replay path: default OFF (the
        # reference's measurement said install dispatches cost more than
        # they saved),
        # overridable for A/B — replay key sets are small and the verifier
        # (with its installed tables) persists across every group of a
        # catchup, so that conclusion deserves a re-test per rig
        self.hot_threshold = hot_threshold
        self.stats = stats if stats is not None else {}
        # ALL device interaction for a group — the verify call's host prep,
        # the kernel enqueue and the wait for its verdicts — runs on ONE
        # background daemon worker, which waits on the card's event with
        # the GIL released while the main thread applies ledgers.  Each job
        # runs under the devices and streams that were current on the
        # dispatching thread (torch keeps both per thread, so a fresh
        # worker would otherwise fall back to its own defaults), and the
        # verifier holds a lock for a whole call, so two worker
        # generations (a wedged one and its successor) never interleave
        # key-table installs and table launches.  collect() waits with a
        # timeout and falls back to on-demand CPU verification if the
        # device wedges — verdicts are then computed by libsodium instead
        # of seeded, so behavior degrades to CPU speed, never to a hang;
        # the daemon worker cannot block interpreter exit.
        self._worker = None
        self._jobs = None
        self._consecutive_wedges = 0
        self._consecutive_losses = 0
        self._first_collect_done = False
        self._disabled = False
        # hint (4 bytes) -> [pk, ...] of every SetOptions-added ed25519
        # signer seen in any dispatched checkpoint (cumulative: covers
        # signers added between the pairing state snapshot and apply)
        self._harvested_hint: Dict[bytes, List[bytes]] = {}
        self._groups: Dict[int, dict] = {}   # checkpoint -> shared group
        self._counted_sigs: Dict[int, int] = {}  # raw-path per-cp totals
        # poll-profile machinery: dispatched-but-unseeded groups in
        # dispatch order, harvested (non-blocking) at every collect.
        # Thread contract: the device worker touches NO
        # pipeline state (see _submit) — every poll-profile field below
        # is read and written only by the dispatch/collect caller, so
        # each carries the owned-by attestation the thread-safety lint
        # checks and @race_checked enforces at runtime under make race.
        self._live_groups: List[dict] = []  # corelint: owned-by=main -- appended at dispatch, drained at collect; the device worker only fills job boxes
        self._collects_since_harvest = 0  # corelint: owned-by=main -- poll stand-down counter, bumped only inside _collect_poll
        self._harvested_once = False  # corelint: owned-by=main -- cold-vs-warm miss budget latch, flipped only in _harvest_ready
        # auto-tuned dispatch-ahead depth (recommended_coalesce): EWMAs of
        # the measured consumer rate (host apply seconds per checkpoint)
        # vs the measured device rate (seconds per paired signature)
        self._last_collect_t: Optional[float] = None  # corelint: owned-by=main -- consumer-rate EWMA input, collect-path only
        self._apply_s_per_cp: Optional[float] = None  # corelint: owned-by=main -- consumer-rate EWMA, collect-path only
        self._device_s_per_pair: Optional[float] = None  # corelint: owned-by=main -- device-rate EWMA; device wall rides home in the job box, folded in on harvest
        self._pairs_per_cp: Optional[float] = None  # corelint: owned-by=main -- dispatch-path EWMA of pairs per checkpoint
        # per-pipeline rate-limit key, unique for process lifetime (an
        # id(self) key would recycle addresses after GC and inherit a
        # dead pipeline's count); discarded in close()
        self._fallback_warn_key = \
            f"preverify-collect-fallback-{next(_PIPELINE_IDS)}"

    # a wedged device job must degrade to CPU-speed verification, not
    # hang the catchup; generous enough for a cold kernel build
    COLLECT_TIMEOUT_S = 180.0
    # after this many consecutive genuine wedges the device is presumed
    # dead and the pipeline disables itself — otherwise a long catchup
    # would pay the full timeout once per group
    MAX_CONSECUTIVE_WEDGES = 2
    # CPU-race bound per PAIRED candidate.  Deliberately tighter than the
    # host's real ~60-70us/verify with libsodium: the group's pair count
    # exceeds its signature count (hint collisions/multisig pair one sig
    # against several candidates), and a device that only ever finishes
    # JUST under a generous budget still loses end-to-end (measured on
    # the reference's device at 10k ledgers: 58.5s of under-budget waits
    # vs the CPU's 34s total).  40us x 1.25 means the
    # device must beat ~50us/pair — clearly faster than libsodium — or
    # the pipeline stands down.
    RACE_CPU_S_PER_SIG = 40e-6
    MAX_CONSECUTIVE_LOSSES = 3
    # collect-fallback warnings are rate-limited: a drifted chip can lose
    # the CPU race on EVERY group (one warning per group),
    # and the interesting signal is the first occurrence + the trend —
    # which catchup.preverify.fallback and stats carry in full
    FALLBACK_WARN_EVERY_N = 10
    # Test seam: when set (class attribute), called as DEVICE_GATE(i)
    # inside the device worker before group i's verdicts materialize.  A
    # test that must lose the CPU race DETERMINISTICALLY blocks the gate
    # for i >= 1 instead of hoping 0.25s of wall clock beats the device
    # (a sleep-race test flakes whenever the device finishes first).
    DEVICE_GATE = None
    # poll profile: a device that NEVER ripens a group still costs pairing
    # host-prep per dispatch — after this many consecutive checkpoint
    # collects without a single harvest the pipeline stands down (the
    # sig-only profile never does).  Before the first harvest ever, the
    # budget is much larger: the first group absorbs the kernel compile
    # (the first call builds the kernels), which can span many
    # checkpoints of misses.
    MAX_POLL_MISS_COLLECTS = 8
    MAX_POLL_MISS_COLLECTS_COLD = 64
    # auto-tuned dispatch-ahead depth bounds (recommended_coalesce)
    MIN_COALESCE = 1
    MAX_COALESCE = 8

    def dispatched(self, checkpoint: int) -> bool:
        return checkpoint in self._groups

    def job_done(self, checkpoint: int) -> bool:
        """True when `checkpoint`'s device verdicts have materialized (its
        collect would return without waiting).  Non-blocking — the
        admission pipeline polls this to keep kernel warmup off the
        submission critical path."""
        group = self._groups.get(checkpoint)
        if group is None or group.get("collected") or group.get("seeded"):
            return True
        job = group["job"]
        if job is None:
            return True
        _box, ev, _q = job
        return ev.is_set()

    def _add_sigs_total(self, n: int) -> None:
        """One accounting seam for the offload hit-rate denominator —
        mirrored into the registry so /metrics and bench agree with
        stats.  The stats dict nets retractions exactly
        (correct_total_for_fallback can pass n < 0); the registry counter
        is clamped non-negative because it renders as a Prometheus
        counter, where a decrease reads as a process restart."""
        self.stats["sigs_total"] = self.stats.get("sigs_total", 0) + n
        if n > 0:
            _registry().counter("catchup.preverify.sigs-total").inc(n)

    def _note_not_dispatched(self, n: int) -> None:
        """Watermark accounting: signatures that never
        reached the device at all — unpairable hints, parser-rejected
        records, a disabled pipeline.  Distinct from 'device lost the
        race' (dispatched but not materialized in time), which
        _collect_poll/_collect_race count on the race-lost meter; the two
        causes used to share one opaque hit-rate gap."""
        if n <= 0:
            return
        self.stats["sigs_not_dispatched"] = \
            self.stats.get("sigs_not_dispatched", 0) + n
        _registry().counter("catchup.preverify.not-dispatched").inc(n)

    def _submit(self, fn):
        """Run fn on the single daemon device-worker; returns (box, event).
        box["result"]/box["error"] is set before event fires.

        Thread contract: the worker body touches NO
        pipeline instance state — only its own job tuple (box/event) and
        the generation-tagged queue, handed over through Queue's internal
        lock and Event's release ordering.  `_worker`/`_jobs` themselves
        are written only from the dispatching (main) thread, which is why
        the thread-safety reachability rule finds the worker role
        field-free."""
        import queue
        import threading
        if self._worker is None:
            jobs = queue.Queue()
            self._jobs = jobs

            def run(jobs=jobs):
                # the worker serves ONLY its own generation's queue: an
                # abandoned (wedged) worker that later un-wedges must not
                # rebind to a successor's queue — two workers draining one
                # queue would reintroduce the concurrent device calls this
                # design exists to prevent
                while True:
                    item = jobs.get()
                    if item is None:
                        return
                    jfn, jbox, jev = item
                    try:
                        jbox["result"] = jfn()
                    except BaseException as e:  # corelint: disable=exception-hygiene -- verdict box re-raised at collect()
                        jbox["error"] = e
                    jev.set()

            self._worker = threading.Thread(target=run, daemon=True,
                                            name="preverify-device")
            self._worker.start()
        box: dict = {}
        ev = threading.Event()
        self._jobs.put((fn, box, ev))
        # the queue ref tags the job's worker generation: after a wedge the
        # stale queue's remaining jobs will never run, and collect() must
        # fall back immediately instead of waiting out a timeout per group
        return box, ev, self._jobs

    def dispatch(self, frames_by_checkpoint: Dict[int, Sequence[TransactionFrame]],
                 ledger_state=None) -> None:
        """Pair + enqueue one device batch covering every checkpoint in
        `frames_by_checkpoint` (ascending order).  No device sync.

        Takes DECODED frames — the same objects the apply will execute
        (decoded once at download, content_hash memoized per frame), so the
        accel pass never re-decodes the replay stream)."""
        if self._disabled:
            # device presumed dead: pure CPU verification.  Still count
            # the signatures so offload_hit_rate() honestly reflects the
            # un-offloaded remainder instead of freezing at ~1.0, and
            # register a no-op collected group so the apply path sees
            # dispatched()==True and does not re-dispatch/double-count.
            total = 0
            for cp in frames_by_checkpoint:
                for frame in frames_by_checkpoint[cp]:
                    total += len(frame.signatures)
            self._add_sigs_total(total)
            self._note_not_dispatched(total)
            cps = sorted(frames_by_checkpoint)
            group = {"job": None, "pks": [], "sigs": [], "msgs": [],
                     "checkpoints": cps, "collected": True}
            for cp in cps:
                self._groups[cp] = group
            return
        import time as _time

        from ..accel.ed25519 import verify_batch_async
        from ..transactions.utils import account_key

        t0 = _time.perf_counter()
        cps = sorted(frames_by_checkpoint)
        signer_cache: Dict[bytes, List[bytes]] = {}

        def signers_of(acc_id_val: bytes) -> List[bytes]:
            if ledger_state is None:
                return []
            got = signer_cache.get(acc_id_val)
            if got is not None:
                return got
            entry = ledger_state.get_entry(account_key(
                X.AccountID.ed25519(acc_id_val)).to_xdr())
            out: List[bytes] = []
            if entry is not None:
                for s in entry.data.value.signers:
                    if s.key.switch == X.SignerKeyType.SIGNER_KEY_TYPE_ED25519:
                        out.append(s.key.value)
            signer_cache[acc_id_val] = out
            return out

        frames: List[TransactionFrame] = []
        for cp in cps:
            frames.extend(frames_by_checkpoint[cp])
        # harvest before pairing: a signer added late in the group still
        # pairs a tx earlier in it (superset candidates are harmless)
        harvested = self._harvested_hint
        for frame in frames:
            for op in frame.operations:
                if op.body.switch == X.OperationType.SET_OPTIONS:
                    signer = op.body.value.signer
                    if signer is not None and signer.key.switch == \
                            X.SignerKeyType.SIGNER_KEY_TYPE_ED25519:
                        pk = signer.key.value
                        lst = harvested.setdefault(pk[28:32], [])
                        if pk not in lst:
                            lst.append(pk)

        pks: List[bytes] = []
        sigs: List[bytes] = []
        msgs: List[bytes] = []
        pairs_by_cp: Dict[int, int] = {}
        for cp in cps:
            total = paired = 0
            for frame in frames_by_checkpoint[cp]:
                h = frame.content_hash()
                account_ids = [frame.source_account_id().value]
                if hasattr(frame, "inner"):
                    account_ids.append(frame.inner.source_account_id().value)
                for op in frame.operations:
                    if op.sourceAccount is not None:
                        account_ids.append(
                            X.muxed_to_account_id(op.sourceAccount).value)
                candidates = list(account_ids)
                for aid in account_ids:
                    candidates.extend(signers_of(aid))
                total += len(frame.signatures)
                for dsig in frame.signatures:
                    seen = set()
                    for pk in candidates:
                        if dsig.hint == pk[28:32] and pk not in seen:
                            seen.add(pk)
                            pks.append(pk)
                            sigs.append(dsig.signature)
                            msgs.append(h)
                    for pk in harvested.get(dsig.hint, ()):
                        if pk not in seen:
                            seen.add(pk)
                            pks.append(pk)
                            sigs.append(dsig.signature)
                            msgs.append(h)
                    if seen:
                        paired += 1
            pairs_by_cp[cp] = paired
            self._add_sigs_total(total)
            self._note_not_dispatched(total - paired)
        # sigs_shipped is counted at COLLECT time (successful seeding
        # only): a group that wedges and falls back to CPU never shipped
        self._enqueue_group(cps, pks, sigs, msgs, t0, pairs_by_cp)

    def dispatch_raw(self, recs_by_checkpoint: Dict[int, Sequence[bytes]]
                     ) -> None:
        """dispatch() for the native path: pairing runs in C straight from
        the raw transaction records (no Python frame decode)."""
        cps = sorted(recs_by_checkpoint)
        if self._disabled or self.pair_extractor is None:
            # count signatures per checkpoint (honest hit rate denominator)
            # without materializing pairs, then register a no-op group
            for cp in cps:
                n = self._count_and_record(cp, recs_by_checkpoint[cp])
                self._add_sigs_total(n)
                self._note_not_dispatched(n)
            group = {"job": None, "pks": [], "sigs": [], "msgs": [],
                     "checkpoints": cps, "collected": True}
            for cp in cps:
                self._groups[cp] = group
            return
        import time as _time
        t0 = _time.perf_counter()
        pks, sigs, msgs = [], [], []
        pairs_by_cp: Dict[int, int] = {}
        for cp in cps:
            # per-checkpoint extraction: records each checkpoint's counted
            # total so the Python-fallback apply can correct the
            # denominator for records the C parser rejected (their
            # signatures are neither paired nor counted here)
            p_, s_, m_, total = self.pair_extractor(recs_by_checkpoint[cp])
            pks.extend(p_)
            sigs.extend(s_)
            msgs.extend(m_)
            # distinct signatures paired (hint collisions pair one sig
            # against several candidates — count the sig once)
            paired = len({bytes(s) for s in s_})
            pairs_by_cp[cp] = paired
            self._counted_sigs[cp] = total
            self._add_sigs_total(total)
            self._note_not_dispatched(total - paired)
        self._enqueue_group(cps, pks, sigs, msgs, t0, pairs_by_cp)

    def _count_and_record(self, cp, recs) -> int:
        from .. import _native_build
        _capply = _native_build.load("_capply")
        n = 0
        for r in recs:
            try:
                _, sig_count = _capply.scan_tx_record(self.network_id, r)
                n += sig_count
            except _capply.Error:
                pass
        self._counted_sigs[cp] = n
        return n

    def correct_total_for_fallback(self, checkpoint: int,
                                   python_total: int) -> None:
        """A probe-rejected checkpoint re-counts its signatures from the
        decoded frames; replace whatever partial count the raw extraction
        recorded for it (records the C parser rejected were uncounted)."""
        counted = self._counted_sigs.pop(checkpoint, None)
        if counted is None:
            return
        self._add_sigs_total(python_total - counted)
        # records the C parser rejected were never paired either — they
        # belong to the never-dispatched bucket, not the race-lost one
        self._note_not_dispatched(python_total - counted)

    def _enqueue_group(self, cps, pks, sigs, msgs, t0,
                       pairs_by_cp: Optional[Dict[int, int]] = None) -> None:
        import time as _time

        from .. import device as _device
        from ..accel.ed25519 import verify_batch_async
        job = None
        if pks:
            # tail_floor=chunk_size: one compiled shape per path, amortized
            # across every checkpoint of the catchup.  hot_threshold
            # selects the per-key-table path (see __init__) vs the
            # single-kernel-per-chunk generic path.
            chunk = self.chunk_size
            hot = self.hot_threshold
            gate = self.DEVICE_GATE
            group_idx = self.stats.get("dispatch_groups", 0)
            devices = self.devices
            # the dispatching thread's current streams: the job enqueues
            # there, after whatever this thread queued before
            streams = _device.current_streams(devices)

            def device_job(pks=pks, sigs=sigs, msgs=msgs):
                if gate is not None:
                    gate(group_idx)
                tj = _time.perf_counter()
                with _DEVICE_CALLS.call(), _device.using(devices, streams):
                    verdicts = verify_batch_async(
                        pks, sigs, msgs, chunk_size=chunk,
                        tail_floor=chunk, hot_threshold=hot,
                        devices=devices)()
                # device wall rides along for the dispatch-depth auto-tune
                return verdicts, _time.perf_counter() - tj

            job = self._submit(device_job)
        group = {"job": job, "pks": pks, "sigs": sigs,
                 "msgs": msgs, "checkpoints": cps,
                 "pairs_by_cp": pairs_by_cp or {},
                 "collected_cps": set()}
        if job is not None:
            self._live_groups.append(group)
        for cp in cps:
            self._groups[cp] = group
        # phase accounting (per-phase breakdown): host prep + enqueue
        dt = _time.perf_counter() - t0
        self.stats["dispatch_s"] = self.stats.get("dispatch_s", 0.0) + dt
        self.stats["dispatch_groups"] = \
            self.stats.get("dispatch_groups", 0) + 1
        _registry().timer("catchup.preverify.dispatch").update(dt)

    def collect(self, checkpoint: int, last: bool = False) -> None:
        """Make `checkpoint`'s verdicts available to the apply (no-op if
        never dispatched or already collected) by seeding the verify
        cache.  Poll/sig-only profiles do not wait: ready groups are
        harvested on the spot, unripe ones fall back to on-demand CPU
        verification (race-lost accounting) and may still seed later
        checkpoints when they ripen.  `last` marks the replay's last
        checkpoint: no later collect could take its group's verdicts, so
        there a poll collect waits for them (_wait_last_group).  The race
        profile keeps the earlier bounded wait.  Later checkpoints of an
        already-collected group stay registered in `_groups` so
        dispatched() keeps answering True for them — popping them all at
        first collect made the apply path re-dispatch each one
        synchronously (measured: every coalesced group was followed by N-1
        redundant singleton dispatches).  Each collect is a
        `catchup.preverify.collect` span: `ripe` whether the group's
        verdicts were in at entry (None: no group to collect); its wait
        is the `catchup.preverify.collect-wait` timer."""
        group = self._groups.get(checkpoint)
        job = group["job"] if group is not None else None
        with tracing.span("catchup.preverify.collect", checkpoint=checkpoint,
                          ripe=job[1].is_set() if job is not None
                          else None):
            if self.profile == self.PROFILE_RACE:
                self._collect_race(checkpoint)
            else:
                self._collect_poll(checkpoint, last)

    def _seed_group(self, group: dict, verdicts) -> None:
        """Push one materialized group's verdicts into the process verify
        cache (and the native engine's, via verdict_sink) — main thread
        only: the sink touches C engine state."""
        pks, sigs, msgs = group["pks"], group["sigs"], group["msgs"]
        keys.seed_verify_cache(
            (pks[i], sigs[i], msgs[i], bool(verdicts[i]))
            for i in range(len(pks)))
        if self.verdict_sink is not None:
            self.verdict_sink(pks, sigs, msgs, verdicts)
        self.stats["sigs_shipped"] = \
            self.stats.get("sigs_shipped", 0) + len(pks)
        _registry().counter("catchup.preverify.sigs-shipped").inc(len(pks))

    def _count_fallback(self, group: dict, why: str) -> None:
        n_fallbacks = self.stats.get("collect_fallbacks", 0) + 1
        self.stats["collect_fallbacks"] = n_fallbacks
        _registry().counter("catchup.preverify.fallback").inc()
        emit, _n = rate_limited(log, self._fallback_warn_key,
                                self.FALLBACK_WARN_EVERY_N)
        emit("preverify group %s for checkpoints %s — falling back to "
             "on-demand CPU verification (occurrence %d)",
             why, group["checkpoints"], n_fallbacks)
        if emit is not log.warning:
            eventlog.record("History", "WARNING",
                            "preverify collect fallback", why=why,
                            checkpoints=str(group["checkpoints"]),
                            occurrence=n_fallbacks)

    def _device_failed(self, group: dict, error: BaseException) -> None:
        """A group's device job raised: on the card the catchup fails here
        (CatchupError), on the plain versions the group falls back to CPU
        verification (the reference's semantics)."""
        if self.raise_device_errors:
            raise CatchupError(
                f"preverify group for checkpoints {group['checkpoints']} "
                f"failed on {', '.join(map(str, self.devices))}: "
                f"{error!r}") from error
        self._count_fallback(group, f"failed: {error}")

    def _harvest_ready(self) -> None:
        """Seed every dispatched group whose device verdicts have
        materialized — a non-blocking sweep run at each collect.  A group
        that ripens after its own checkpoints started applying still seeds
        here: the group's LATER checkpoints (coalesced dispatch) then hit
        the cache instead of recomputing (counted as sigs_late_seeded)."""
        if not self._live_groups:
            return
        harvested = False
        for group in list(self._live_groups):
            box, ev, q = group["job"]
            if not ev.is_set():
                if q is not self._jobs:
                    # stale worker generation (dropped at disable): these
                    # verdicts are never coming
                    self._live_groups.remove(group)
                    group["seeded"] = True
                    self._count_fallback(group, "stranded on a dropped "
                                         "worker generation")
                continue
            self._live_groups.remove(group)
            group["seeded"] = True
            if "error" in box:
                self._device_failed(group, box["error"])
                continue
            verdicts, dur_s = box["result"]
            self._seed_group(group, verdicts)
            n_pairs = max(1, len(group["pks"]))
            self._device_s_per_pair = self._ewma(
                self._device_s_per_pair, dur_s / n_pairs)
            self._pairs_per_cp = self._ewma(
                self._pairs_per_cp,
                len(group["pks"]) / max(1, len(group["checkpoints"])))
            late = sum(group.get("pairs_by_cp", {}).get(c, 0)
                       for c in group.get("collected_cps", ()))
            if late:
                # seeded after those checkpoints' applies already began:
                # their earlier ledgers recomputed on CPU, the rest hit
                self.stats["sigs_late_seeded"] = \
                    self.stats.get("sigs_late_seeded", 0) + late
                _registry().counter("catchup.preverify.late-seeded") \
                    .inc(late)
            harvested = True
        if harvested:
            self._harvested_once = True
            self._collects_since_harvest = 0

    def _wait_last_group(self, group: dict) -> None:
        """Wait for the group of the replay's last checkpoint.  Without a
        wait its verdicts would reach no apply (a replay of one
        checkpoint, such as a fresh range worker's, would verify all of
        it on the CPU while the card computes the same verdicts).  While
        the device has not yet answered this pipeline (its context and
        kernels still loading) the wait may last the wedge timeout, as the
        race profile's first collect; after that, as long as the CPU would
        take for the group.  A stale worker generation is not waited
        for."""
        import time as _time
        box, ev, q = group["job"]
        if ev.is_set() or q is not self._jobs:
            return
        budget = (self.COLLECT_TIMEOUT_S if not self._harvested_once
                  else min(self.COLLECT_TIMEOUT_S,
                           max(0.25, len(group["pks"])
                               * self.RACE_CPU_S_PER_SIG * 1.25)))
        t0 = _time.perf_counter()
        ev.wait(budget)
        wait = _time.perf_counter() - t0
        self.stats["collect_wait_s"] = \
            self.stats.get("collect_wait_s", 0.0) + wait
        _registry().timer("catchup.preverify.collect-wait").update(wait)

    def _collect_poll(self, checkpoint: int, last: bool = False) -> None:
        """Never-wait collect: harvest whatever has ripened; a miss for
        THIS checkpoint degrades to on-demand CPU verification (verdicts
        identical — only where they're computed differs) and is metered
        as a race loss.  The device can only ever ADD throughput.  The
        one wait is at the replay's `last` checkpoint, whose group no
        later collect could harvest (_wait_last_group)."""
        import time as _time
        now = _time.perf_counter()
        if self._last_collect_t is not None:
            dt = now - self._last_collect_t
            if 0.0 < dt < 30.0:   # ignore boot/compile outliers
                self._apply_s_per_cp = self._ewma(self._apply_s_per_cp, dt)
        self._last_collect_t = now
        group = self._groups.pop(checkpoint, None)
        self._harvest_ready()
        if group is None or group.get("collected") or group["job"] is None:
            return
        if last and not group.get("seeded"):
            self._wait_last_group(group)
            self._harvest_ready()
        if group.get("seeded"):
            group.setdefault("collected_cps", set()).add(checkpoint)
            return
        # the device lost the race for this checkpoint: its signatures
        # verify on CPU during the apply; the group stays live and may
        # still seed the later checkpoints it covers
        group.setdefault("collected_cps", set()).add(checkpoint)
        paired = group.get("pairs_by_cp", {}).get(checkpoint, 0)
        self.stats["sigs_race_lost"] = \
            self.stats.get("sigs_race_lost", 0) + paired
        self.stats["collect_race_misses"] = \
            self.stats.get("collect_race_misses", 0) + 1
        if paired:
            _registry().counter("catchup.preverify.race-lost").inc(paired)
        self._collects_since_harvest += 1
        budget = (self.MAX_POLL_MISS_COLLECTS if self._harvested_once
                  else self.MAX_POLL_MISS_COLLECTS_COLD)
        if self.profile != self.PROFILE_SIG_ONLY \
                and self._collects_since_harvest >= budget:
            # the device has not produced one verdict across `budget`
            # checkpoints: stop paying pairing prep for it.  The worker
            # generation is abandoned (daemon; dies with the process).
            self._disabled = True
            self._worker = None
            self._jobs = None
            log.warning(
                "preverify pipeline DISABLED after %d checkpoint collects "
                "without a single materialized device group — remaining "
                "catchup verifies on CPU", self._collects_since_harvest)

    def _collect_race(self, checkpoint: int) -> None:
        """The opt-in earlier behavior: a bounded wait for the
        group's verdicts (the admission pipeline needs them to answer the
        submitter), with wedge/race-loss disable."""
        group = self._groups.pop(checkpoint, None)
        if group is None or group.get("collected"):
            return
        group["collected"] = True
        if group in self._live_groups:
            self._live_groups.remove(group)
        job = group["job"]
        if job is None:
            return
        import time as _time
        box, ev, q = job
        t0 = _time.perf_counter()
        stale = q is not self._jobs and not ev.is_set()
        # RACE-BOUNDED wait: with the native apply engine the device is
        # the replay critical path, so waiting longer than the group's
        # CPU-verify cost LOSES outright (measured on the reference's
        # device: a drifted chip turned a 3s replay into 55s of
        # collect_wait).  Bound the wait by
        # what libsodium would charge for the group; a miss skips seeding
        # (the engine recomputes on CPU — verdicts identical) without
        # abandoning the worker, and repeated losses disable the pipeline
        # for the rest of the catchup.  The FIRST collect keeps the long
        # wedge timeout: it absorbs kernel compiles and is the only probe
        # that can tell a wedged device from a slow one.
        if self._first_collect_done:
            budget = min(self.COLLECT_TIMEOUT_S,
                         max(0.25, len(group["pks"])
                             * self.RACE_CPU_S_PER_SIG * 1.25))
        else:
            budget = self.COLLECT_TIMEOUT_S
        if stale:
            done = False   # stale worker generation: never going to finish
        else:
            done = ev.wait(budget)
        # sync stall: how long the apply cursor waited on the device —
        # ~0 when double-buffering hid the compute under earlier applies
        wait = _time.perf_counter() - t0
        self.stats["collect_wait_s"] = \
            self.stats.get("collect_wait_s", 0.0) + wait
        _registry().timer("catchup.preverify.collect-wait").update(wait)
        race_loss = (not done and not stale
                     and budget < self.COLLECT_TIMEOUT_S)
        first = not self._first_collect_done
        self._first_collect_done = True
        if done and "error" in box and self.raise_device_errors:
            self._device_failed(group, box["error"])
        if not done or "error" in box:
            n_fallbacks = self.stats.get("collect_fallbacks", 0) + 1
            self.stats["collect_fallbacks"] = n_fallbacks
            _registry().counter("catchup.preverify.fallback").inc()
            # first occurrence + every Nth at WARNING (with the running
            # count); the rest at DEBUG — the per-group counter metric
            # above keeps the exact tally either way
            why = (("lost the CPU race" if race_loss else "timed out")
                   if not done else f"failed: {box.get('error')}")
            # keyed per pipeline: each catchup gets its own loud first
            # occurrence, and the emit cadence tracks the same count the
            # message prints (a process-wide key would let an earlier
            # catchup swallow this one's first WARNING)
            emit, _n = rate_limited(log, self._fallback_warn_key,
                                    self.FALLBACK_WARN_EVERY_N)
            emit(
                "preverify collect %s for checkpoints %s — falling back to "
                "on-demand CPU verification (occurrence %d%s)",
                why, group["checkpoints"], n_fallbacks,
                "" if n_fallbacks == 1 else
                f"; warning logged every {self.FALLBACK_WARN_EVERY_N}th")
            if emit is not log.warning:
                # quiet occurrences still land in the flight recorder
                # with structured fields; loud ones arrive via the
                # WARNING bridge — never both (duplicates would burn
                # bounded ring slots on a degraded catchup)
                eventlog.record("History", "WARNING",
                                "preverify collect fallback",
                                why=why,
                                checkpoints=str(group["checkpoints"]),
                                occurrence=n_fallbacks)
            if race_loss:
                # the device is slower than libsodium on this group; the
                # worker keeps running (its queue drains eventually) but
                # repeated losses mean the chip can't win today
                self._consecutive_losses += 1
                self.stats["race_losses"] = \
                    self.stats.get("race_losses", 0) + 1
                lost = sum(group.get("pairs_by_cp", {}).values())
                self.stats["sigs_race_lost"] = \
                    self.stats.get("sigs_race_lost", 0) + lost
                if lost:
                    _registry().counter("catchup.preverify.race-lost") \
                        .inc(lost)
                if self._consecutive_losses >= self.MAX_CONSECUTIVE_LOSSES:
                    self._disabled = True
                    log.warning(
                        "preverify pipeline DISABLED after %d consecutive "
                        "CPU-race losses — the device is slower than "
                        "libsodium on this rig right now; remaining "
                        "catchup verifies on CPU", self._consecutive_losses)
            elif not done and not stale:
                # a genuine wedge (full timeout, incl. the first-collect
                # compile grace): abandon this worker generation (the
                # daemon thread stays blocked harmlessly); a stale job's
                # current worker is healthy and keeps serving
                self._worker = None
                self._jobs = None
                self._consecutive_wedges += 1
                if first or self._consecutive_wedges >= \
                        self.MAX_CONSECUTIVE_WEDGES:
                    self._disabled = True
                    log.warning(
                        "preverify pipeline DISABLED after %d consecutive "
                        "device wedges — remaining catchup verifies on CPU",
                        self._consecutive_wedges)
            return
        self._consecutive_wedges = 0
        self._consecutive_losses = 0
        verdicts, _dur_s = box["result"]
        self._seed_group(group, verdicts)

    @staticmethod
    def _ewma(prev: Optional[float], x: float,
              alpha: float = 0.3) -> float:
        return x if prev is None else prev + alpha * (x - prev)

    def recommended_coalesce(self, current: int) -> int:
        """Dispatch-ahead depth auto-tuned against the measured consumer
        rate (poll/sig-only profiles; CatchupWork consults this before
        every dispatch sweep).  When the device's measured per-checkpoint
        verify time exceeds the host's per-checkpoint apply time the depth
        GROWS — bigger coalesced groups amortize the per-dispatch
        overhead, and in poll mode a late group costs nothing.  When the
        device is comfortably ahead the depth shrinks so seeds stay fresh
        (smaller groups materialize sooner)."""
        if self._disabled:
            return current
        if self._apply_s_per_cp is None or self._device_s_per_pair is None \
                or self._pairs_per_cp is None:
            return current
        device_s_per_cp = self._device_s_per_pair * self._pairs_per_cp
        if device_s_per_cp > self._apply_s_per_cp:
            return min(self.MAX_COALESCE, current * 2)
        if device_s_per_cp < 0.5 * self._apply_s_per_cp:
            return max(self.MIN_COALESCE, current - 1)
        return current

    def close(self) -> None:
        """Release the device worker (a pipeline is per-catchup; a node
        that resyncs repeatedly must not accumulate idle workers).  A
        healthy worker exits on the None sentinel; a wedged one is daemon
        and dies with the process.  On the card, a group that finished with
        an error no collect saw still fails the catchup here."""
        if self._jobs is not None:
            self._jobs.put(None)
        self._worker = None
        self._jobs = None
        live, self._live_groups = self._live_groups, []
        discard_rate_limit(self._fallback_warn_key)
        if self.raise_device_errors:
            for group in live:
                box, ev, _q = group["job"]
                if ev.is_set() and "error" in box:
                    self._device_failed(group, box["error"])


def preverify_checkpoint_signatures(network_id: bytes,
                                    tx_entries: Sequence[X.TransactionHistoryEntry],
                                    chunk_size: int = 2048,
                                    ledger_state=None) -> Dict[str, int]:
    """Synchronous single-checkpoint wrapper over PreverifyPipeline
    (dispatch + immediate collect) — kept for differential tests and
    callers outside the pipelined catchup DAG."""
    frames = [TransactionFrame.make_from_wire(network_id, env)
              for entry in tx_entries for env in entry.txSet.txs]
    pipe = PreverifyPipeline(network_id, chunk_size)
    try:
        pipe.dispatch({0: frames}, ledger_state=ledger_state)
        pipe.collect(0)
    finally:
        pipe.close()
    return {"total": pipe.stats.get("sigs_total", 0),
            "shipped": pipe.stats.get("sigs_shipped", 0)}


@dataclass
class CatchupRange:
    """Partition of a catchup target into a bucket-apply point and a
    replay range (reference: src/catchup/CatchupRange.{h,cpp} — the
    `--at X --count N` / CATCHUP_RECENT planning)."""
    apply_buckets_at: Optional[int]   # checkpoint to assume; None = genesis
    replay_to: int

    @property
    def replay_from(self) -> int:
        return (self.apply_buckets_at + 1 if self.apply_buckets_at
                else 2)


def plan_catchup_range(target: int, count: Optional[int]) -> CatchupRange:
    """Choose the newest published checkpoint boundary that still leaves
    >= `count` ledgers to replay before `target` (reference:
    CatchupRange's 'replayed range covers count, buckets cover the rest').
    count=None (CATCHUP_COMPLETE) replays everything from genesis."""
    freq = checkpoint_frequency()
    first_boundary = freq - 1   # 63 at the default cadence
    if count is None or target - count < first_boundary:
        return CatchupRange(apply_buckets_at=None, replay_to=target)
    boundary = ((target - count + 1) // freq) * freq - 1
    if boundary < first_boundary:
        return CatchupRange(apply_buckets_at=None, replay_to=target)
    return CatchupRange(apply_buckets_at=boundary, replay_to=target)


def _archive_state(archive: FileHistoryArchive, checkpoint=None):
    """get_state with hostile-HAS errors localized to CatchupError."""
    try:
        return archive.get_state(checkpoint)
    except (ValueError, OSError) as e:
        raise CatchupError(f"malformed archive HAS: {e}") from e


class CatchupManager:
    """Replay/assume-state manager (reference: CatchupManagerImpl +
    CatchupWork).  `accel=True` routes checkpoint signature verification
    through the card's batch verifier: `accel_device` / `accel_devices`
    (None: the card, raising here where CUDA is not available; "cpu": the
    plain versions), threaded through CatchupWork to PreverifyPipeline."""

    def __init__(self, network_id: bytes, network_passphrase: str,
                 accel: bool = False, accel_chunk: int = 2048,
                 invariant_manager=None,
                 accel_hot_threshold: int = 1 << 62,
                 native: Optional[bool] = None,
                 bucket_store=None,
                 entry_cache_size: Optional[int] = None,
                 resident_levels: Optional[int] = None,
                 accel_profile: Optional[str] = None,
                 accel_device=None, accel_devices=None):
        """invariant_manager: None (default — the bench/hot replay path;
        the hash chain is the corruption *detector*) or an
        InvariantManager to also *localize* faults during replay and
        bucket apply (reference: INVARIANT_CHECKS honored in catchup).

        native: route supported checkpoints through the native C apply
        engine (native/capply.c).  Default (None) = auto: on when the
        extension is built, no invariants are requested (the invariant
        hooks live on the Python close path), and STELLAR_TPU_NO_CAPPLY
        is unset.  An EXPLICIT native=True that cannot be honored logs a
        prominent warning instead of silently degrading.  The Python
        engine remains the oracle and the fallback for unsupported tx
        shapes.

        bucket_store: a bucket.manager.BucketListStore → every
        LedgerManager this catchup builds runs in BucketListDB mode
        (`in_memory_ledger = false`): assumed/replayed state lives in
        indexed on-disk bucket files, reads go through the bounded
        `entry_cache_size` LRU, and bucket-list levels >=
        `resident_levels` (config BUCKET_RESIDENT_LEVELS) stay
        disk-resident — streaming decode-free merges, no decoded entry
        lists."""
        self.network_id = network_id
        self.network_passphrase = network_passphrase
        self.accel = accel
        self.accel_chunk = accel_chunk
        self.accel_hot_threshold = accel_hot_threshold
        # offload profile (PreverifyPipeline docstring): None = the
        # pipeline default ("poll" — the device can only add throughput)
        self.accel_profile = accel_profile
        self.accel_device = accel_device
        self.accel_devices = accel_devices
        if accel:
            # fail here, not at the first dispatch, where there is no card
            resolve_accel_devices(accel_device, accel_devices,
                                  PreverifyPipeline.DEFAULT_DEVICE)
        self.invariant_manager = invariant_manager
        self.bucket_store = bucket_store
        self.entry_cache_size = entry_cache_size
        self.resident_levels = resident_levels
        from ..ledger.native_apply import native_apply_available
        self.native = (native if native is not None else True) \
            and native_apply_available() and invariant_manager is None
        if native is True and not self.native:
            # an explicit request that cannot be honored must be LOUD —
            # the Python path is ~an order of magnitude slower
            reason = ("an invariant_manager forces the Python apply path"
                      if native_apply_available() else
                      "the _capply extension is not built, libsodium "
                      "does not load, or STELLAR_TPU_NO_CAPPLY is set")
            log.warning(
                "native apply engine EXPLICITLY requested but unavailable "
                "(%s) — falling back to the ~10x slower Python engine",
                reason)
        # offload hit-rate accounting
        self.stats = {"sigs_total": 0, "sigs_shipped": 0}

    def offload_hit_rate(self) -> float:
        t = self.stats["sigs_total"]
        return self.stats["sigs_shipped"] / t if t else 0.0

    # -- archive readers ----------------------------------------------------
    def _read_headers(self, archive: FileHistoryArchive,
                      checkpoint: int) -> List[X.LedgerHeaderHistoryEntry]:
        try:
            recs = archive.get_xdr_file(
                category_path(CATEGORY_LEDGER, checkpoint))
            if recs is None:
                raise CatchupError(
                    f"missing ledger file for checkpoint {checkpoint}")
            return [_LHHE.unpack(r) for r in recs]
        except (X.XdrError, ValueError, OSError) as e:
            # hostile/corrupt stream: bad gzip, truncated record, inflate
            # cap exceeded, XDR decode failure — one localized error class
            raise CatchupError(
                f"corrupt ledger file at checkpoint {checkpoint}: {e}") from e

    # -- complete replay (from genesis) ------------------------------------
    def _release_bridge(self, mgr, bridge) -> None:
        """Detach the native engine after a replay: its state goes back to
        the Python manager and its counters into stats."""
        mgr.native_bridge = None
        if bridge.active:
            bridge.export_to_manager(mgr)
        self.stats.update(
            {f"native_{k}": v for k, v in bridge.stats().items()})
        # checkpoint outcome split: how
        # many checkpoints ran native vs fell back to Python
        self.stats["native_checkpoints"] = \
            self.stats.get("native_checkpoints", 0) \
            + bridge.native_checkpoints
        self.stats["native_fallback_checkpoints"] = \
            self.stats.get("native_fallback_checkpoints", 0) \
            + bridge.fallback_checkpoints

    def catchup_complete(self, archive: FileHistoryArchive,
                         to_ledger: Optional[int] = None,
                         clock=None, lookahead: int = 2,
                         checkpoint_hook=None) -> LedgerManager:
        """Replay every ledger from genesis to the target, built from the
        historywork DAG: per-checkpoint download/verify units run
        `lookahead` ahead of the sequential cooperative apply, with retry
        backoff on archive corruption (reference: CATCHUP_COMPLETE —
        CatchupWork + DownloadApplyTxsWork + ApplyCheckpointWork)."""
        from ..historywork.works import CatchupWork
        from ..util.clock import ClockMode, VirtualClock

        has = _archive_state(archive)
        if has is None:
            raise CatchupError("archive has no HAS")
        target = to_ledger if to_ledger is not None else has.current_ledger

        mgr = LedgerManager(self.network_id,
                            invariant_manager=self.invariant_manager,
                            bucket_store=self.bucket_store,
                            entry_cache_size=self.entry_cache_size,
                            resident_levels=self.resident_levels)
        mgr.start_new_ledger()
        self._run_catchup_work(mgr, archive, target, clock, lookahead,
                               checkpoint_hook)
        return mgr

    def _run_catchup_work(self, mgr: LedgerManager,
                          archive: FileHistoryArchive, target: int,
                          clock=None, lookahead: int = 2,
                          checkpoint_hook=None) -> int:
        """Crank a CatchupWork DAG from mgr's current LCL to `target`
        (shared by complete and recent modes).  `checkpoint_hook(lcl)`
        runs after every applied checkpoint; returning a lower ledger
        (a published boundary >= lcl) TRUNCATES the target — the
        work-stealing seam (catchup.parallel): a range worker that
        accepted a steal limit stops at the split boundary.  Returns the
        effective target actually replayed to."""
        from ..historywork.works import CatchupWork
        from ..util.clock import ClockMode, VirtualClock

        if clock is None:
            clock = VirtualClock(ClockMode.VIRTUAL_TIME)
        bridge = None
        if self.native:
            from ..ledger.native_apply import NativeApplyBridge
            bridge = NativeApplyBridge(self.network_id)
            bridge.import_from(mgr)
            mgr.native_bridge = bridge
        work = CatchupWork(clock, mgr, archive, target, self.network_id,
                           accel=self.accel, accel_chunk=self.accel_chunk,
                           lookahead=lookahead, stats=self.stats,
                           accel_hot_threshold=self.accel_hot_threshold,
                           # with the native engine, BOTH apply and accel
                           # pairing parse raw records in C — Python frame
                           # decode happens only on fallback checkpoints
                           decode_txs=not self.native,
                           keep_raw=self.native,
                           accel_profile=self.accel_profile,
                           accel_device=self.accel_device,
                           accel_devices=self.accel_devices,
                           checkpoint_hook=checkpoint_hook,
                           # this replay owns its clock: its last
                           # collect may wait for the card
                           wait_last=True,
                           verdict_sink=(bridge.seed_verdicts
                                         if bridge is not None and self.accel
                                         else None),
                           pair_extractor=(bridge.extract_pairs
                                           if bridge is not None and
                                           self.accel else None))
        work.start()
        try:
            while not work.done:
                if clock.crank() == 0:
                    raise CatchupError("catchup work stalled")
        finally:
            # a stalled DAG never reaches the work's finish hooks — the
            # collector thread must still be released (and on the card a
            # failed device job no collect saw raises here)
            try:
                work._close_pipeline()
            finally:
                if bridge is not None:
                    self._release_bridge(mgr, bridge)
        if not work.succeeded:
            detail = work.error_detail or "unknown failure"
            raise CatchupError(
                f"catchup ended at {mgr.last_closed_ledger_seq}, "
                f"target {target}: {detail}")
        # the hook may have truncated the target (work stealing): the
        # WORK's target is the authoritative one the replay must reach
        if mgr.last_closed_ledger_seq != work.target:
            raise CatchupError(
                f"catchup ended at {mgr.last_closed_ledger_seq}, "
                f"target {work.target}")
        return work.target

    # -- recent (assume buckets at a boundary, replay the tail) -------------
    def catchup_recent(self, archive: FileHistoryArchive, count: int,
                       to_ledger: Optional[int] = None,
                       clock=None, lookahead: int = 2) -> LedgerManager:
        """CATCHUP_RECENT / `catchup --at X --count N`: assume the bucket
        snapshot at the newest checkpoint leaving >= count ledgers to
        replay, then replay the tail to the target (reference:
        CatchupWork over a CatchupRange with both bucket-apply and replay
        segments)."""
        has = _archive_state(archive)
        if has is None:
            raise CatchupError("archive has no HAS")
        target = to_ledger if to_ledger is not None else has.current_ledger
        rng = plan_catchup_range(target, count)
        if rng.apply_buckets_at is None:
            return self.catchup_complete(archive, to_ledger=target,
                                         clock=clock, lookahead=lookahead)
        log.info("catchup range: buckets at %d, replay %d..%d",
                 rng.apply_buckets_at, rng.replay_from, rng.replay_to)
        mgr = self.catchup_minimal(archive, checkpoint=rng.apply_buckets_at)
        if mgr.last_closed_ledger_seq < target:
            self._run_catchup_work(mgr, archive, target, clock, lookahead)
        return mgr

    # -- one range of a parallel catchup ------------------------------------
    def catchup_range(self, archive: FileHistoryArchive,
                      seed_checkpoint: Optional[int], to_ledger: int,
                      clock=None, lookahead: int = 2,
                      checkpoint_hook=None):
        """Replay one contiguous checkpoint range: assume the hash-verified
        bucket snapshot at `seed_checkpoint` (None = replay from genesis),
        then replay through `to_ledger` with full verification.  Returns
        (manager, seed_header_hash) — the seed hash is the stitch evidence
        a parallel orchestrator checks against the previous range's final
        ledger hash (catchup.parallel.verify_stitches).  `checkpoint_hook`
        (see _run_catchup_work) lets a work-stealing orchestrator truncate
        the range at a later boundary mid-replay."""
        if seed_checkpoint is None:
            return (self.catchup_complete(archive, to_ledger=to_ledger,
                                          clock=clock, lookahead=lookahead,
                                          checkpoint_hook=checkpoint_hook),
                    None)
        mgr = self.catchup_minimal(archive, checkpoint=seed_checkpoint)
        seed_hash = mgr.lcl_hash
        if mgr.last_closed_ledger_seq < to_ledger:
            self._run_catchup_work(mgr, archive, to_ledger, clock,
                                   lookahead, checkpoint_hook)
        return mgr, seed_hash

    # -- minimal (assume state from buckets, no replay) ---------------------
    def catchup_minimal(self, archive: FileHistoryArchive,
                        checkpoint: Optional[int] = None) -> LedgerManager:
        """Assume a checkpoint's state snapshot from bucket files
        (reference: ApplyBucketsWork + BucketApplicator), verifying every
        bucket hash and the reassembled bucket-list hash against the
        header.  `checkpoint` targets a specific published boundary (the
        CatchupRange bucket-apply point); default = the archive tip.
        Spanned and timed as catchup.bucket-apply."""
        with tracing.timed_span("catchup.bucket-apply"):
            return self._catchup_minimal(archive, checkpoint)

    def _catchup_minimal(self, archive: FileHistoryArchive,
                         checkpoint: Optional[int]) -> LedgerManager:
        has = _archive_state(archive, checkpoint)
        if has is None:
            raise CatchupError(
                "archive has no HAS" if checkpoint is None
                else f"archive has no HAS for checkpoint {checkpoint}")
        if checkpoint is not None and has.current_ledger != checkpoint:
            # a mirror that serves the wrong HAS here would silently skip
            # the whole replay tail of a CATCHUP_RECENT plan — fail-stop
            raise CatchupError(
                f"archive HAS for checkpoint {checkpoint} claims ledger "
                f"{has.current_ledger}")
        checkpoint = has.current_ledger
        headers = self._read_headers(archive, checkpoint)
        verify_ledger_chain(headers)
        tail = headers[-1]
        if tail.header.ledgerSeq != checkpoint:
            raise CatchupError("checkpoint tail mismatch")

        mgr = LedgerManager(self.network_id,
                            invariant_manager=self.invariant_manager,
                            bucket_store=self.bucket_store,
                            entry_cache_size=self.entry_cache_size,
                            resident_levels=self.resident_levels)
        mgr.start_new_ledger()  # scaffolding; replaced below

        hashes = has.bucket_hashes()
        if len(hashes) != NUM_LEVELS * 2:
            raise CatchupError("HAS bucket list malformed")
        empty = "0" * 64

        def source(idx: int) -> Bucket:
            hh = hashes[idx]
            if hh == empty:
                return Bucket.empty()
            try:
                b = archive.get_bucket(hh)
            except (ValueError, OSError) as e:
                # content-hash mismatch / hostile gzip: localized fail-stop
                raise CatchupError(f"corrupt bucket {hh}: {e}") from e
            if b is None:
                raise CatchupError(f"missing bucket {hh}")
            return b

        def next_source(level: int):
            try:
                return has.rehydrate_next(level, archive.get_bucket)
            except RuntimeError as e:
                raise CatchupError(str(e)) from e

        from ..ledger.manager import assume_bucket_state
        scaffold_root = mgr.root
        try:
            mgr.root = assume_bucket_state(
                mgr.bucket_list, tail.header, source, next_source,
                invariant_manager=self.invariant_manager,
                store=self.bucket_store,
                entry_cache_size=mgr.entry_cache_size)
        except RuntimeError as e:
            raise CatchupError(str(e)) from e
        if scaffold_root is not None and scaffold_root.disk_backed:
            scaffold_root.release_snapshot()  # genesis scaffolding pins
        mgr.lcl_header = tail.header
        mgr.lcl_hash = tail.hash
        log.info("assumed state at ledger %d (%d entries)",
                 checkpoint, mgr.root.entry_count())
        return mgr
