"""Application: the composition root that turns a Config into a live node.

Reference: src/main/ApplicationImpl.{h,cpp} — owns the VirtualClock and
every subsystem (Database, BucketManager, LedgerManager, Herder,
OverlayManager, HistoryManager, CatchupManager, CommandHandler), starts
them in dependency order, and runs the crank loop.

The copy of stellar_core_tpu/main/application.py.  What differs is
where signatures verify: ``Config.accel()`` decides it for admission,
the catchup manager and the in-place archive catchup alike — ACCEL
"cuda" verifies on the card (and refuses to start where CUDA is not
available), "cpu" on the kernels' plain versions, "none" turns the
offload off.  Also: a node that starts out of sync past the peers' slot
memory reaches the archive (the herder's sync-gap hook), /metrics
carries where this process verifies (``accel_use``), and `run`'s signal
handler only ends the crank loop (``request_stop``).
"""

from __future__ import annotations

import os
from typing import List, Optional

from .. import xdr as X
from ..bucket.manager import BucketDir
from ..catchup.catchup import CatchupManager
from ..database import Database, PersistentState
from ..herder.herder import Herder
from ..history.archive import FileHistoryArchive
from ..history.manager import HistoryManager
from ..invariant import InvariantManager
from ..ledger.manager import LedgerManager
from ..overlay.overlay_manager import OverlayManager
from ..overlay.tcp import TCPTransport
from ..util import logging as slog
from ..util.clock import ClockMode, VirtualClock
from .config import Config

log = slog.get("Main")

VERSION = "stellar-core-tpu-torch 2.0.0"


def _herder_bundle(app) -> dict:
    """Herder/SCP state for crash bundles (registered via weakref: a
    torn-down node reports itself gone instead of pinning its graph)."""
    if app is None:
        return {"gone": True}
    return {
        "state": app.herder.get_state_human(),
        "tracking_ledger": app.herder.tracking_consensus_ledger_index(),
        "tx_queue_depth": app.herder.tx_queue.size,
        "buffered_slots": sorted(app.herder._buffered),
        "ledger_timespan_s": app.herder.ledger_timespan,
        "lcl": {"seq": app.lm.last_closed_ledger_seq,
                "hash": app.lm.lcl_hash.hex(),
                "close_time": app.lm.lcl_header.scpValue.closeTime},
    }


def _config_fingerprint(app) -> dict:
    """Enough config identity to tell WHICH deployment produced a crash
    bundle without leaking secrets (no seeds, no peer credentials)."""
    if app is None:
        return {"gone": True}
    cfg = app.config
    return {
        "network_passphrase": cfg.NETWORK_PASSPHRASE,
        "network_id": app.network_id.hex(),
        "node": app.node_secret.public_key.to_strkey(),
        "is_validator": cfg.NODE_IS_VALIDATOR,
        "run_standalone": cfg.RUN_STANDALONE,
        "in_memory_ledger": cfg.IN_MEMORY_LEDGER,
        "bucket_resident_levels": cfg.BUCKET_RESIDENT_LEVELS,
        "accel": cfg.ACCEL,
        "log_format": cfg.LOG_FORMAT,
        "worker_threads": cfg.WORKER_THREADS,
    }


def _timeseries_bundle(app) -> dict:
    """Trailing time-series window for crash bundles (weakref-fed)."""
    if app is None or app.timeseries is None:
        return {"gone": True}
    return app.timeseries.bundle()


def _anomaly_bundle(app) -> dict:
    """Anomaly verdicts for crash bundles (weakref-fed)."""
    if app is None or app.anomaly is None:
        return {"gone": True}
    return app.anomaly.report()


def _app_timeseries(app):
    return app.timeseries if app is not None else None


def _app_closecosts(app):
    return app.lm.close_costs if app is not None else None


class Application:
    def __init__(self, config: Config,
                 clock: Optional[VirtualClock] = None,
                 listen: bool = True):
        self.config = config
        config.apply_process_globals()
        self.clock = clock or VirtualClock(ClockMode.REAL_TIME)
        # (on, device) of ACCEL; resolved here, so that a node told to
        # verify on the card fails at start where there is none
        self.accel, self.accel_device = config.accel()
        self.accel_devices = []
        if self.accel:
            from ..catchup.catchup import (PreverifyPipeline,
                                           resolve_accel_devices)
            self.accel_devices = resolve_accel_devices(
                self.accel_device, None, PreverifyPipeline.DEFAULT_DEVICE)
        self.network_id = config.network_id()
        self.node_secret = config.node_secret()
        slog.set_level(config.LOG_LEVEL)
        slog.set_format(config.LOG_FORMAT)
        if config.NODE_NAME:
            # fleet attribution: JSON log records, flight-event exports
            # and /tracespans documents all carry this node's name
            slog.set_node_id(config.NODE_NAME)

        # incident observability: per-category status lines (reference:
        # StatusManager feeding /info), the node.health gauge behind
        # /health, and post-mortem bundle sources (herder/SCP state +
        # config fingerprint ride along in every crash bundle)
        from ..util import eventlog
        from ..util.metrics import registry as _registry
        from .status import StatusManager, health_gauge_value
        self.status = StatusManager()
        _registry().weak_gauge("node.health", self, health_gauge_value)
        eventlog.install_thread_excepthook()
        import weakref
        ref = weakref.ref(self)
        eventlog.register_bundle_source(
            "herder", lambda: _herder_bundle(ref()))
        eventlog.register_bundle_source(
            "config", lambda: _config_fingerprint(ref()))
        # always-on sampling profiler (util/sampleprof): config flag or
        # STPU_SAMPLEPROF=1; its folded stacks join every crash bundle
        from ..util import sampleprof
        if config.SAMPLEPROF:
            sampleprof.profiler().start()
        else:
            sampleprof.start_if_configured()
        # local SLO burn tracking (util/slo): evaluated on a clock timer
        # so /slo answers with per-objective burn rates; 0 cadence = off
        self.slo_tracker = None
        self._slo_timer = None
        if config.SLO_EVAL_CADENCE_S > 0:
            from ..util.slo import SLOTracker, default_objectives
            self.slo_tracker = SLOTracker(
                default_objectives(
                    close_p99_s=config.SLO_CLOSE_P99_S,
                    admission_p99_s=config.SLO_ADMISSION_P99_S,
                    catchup_rate=config.SLO_CATCHUP_RATE,
                    budget=config.SLO_BURN_BUDGET),
                source=config.NODE_NAME or "local")
            self._arm_slo_timer()

        # database + buckets ------------------------------------------------
        self.database: Optional[Database] = None
        self.bucket_dir: Optional[BucketDir] = None
        self.bucket_store = None   # BucketListDB authority when enabled
        if config.DATABASE:
            os.makedirs(os.path.dirname(config.DATABASE) or ".",
                        exist_ok=True)
            self.database = Database(config.DATABASE)
            bdir = config.BUCKET_DIR_PATH or os.path.join(
                os.path.dirname(config.DATABASE) or ".", "buckets")
            self.bucket_dir = BucketDir(bdir)
        if not config.IN_MEMORY_LEDGER:
            # BucketListDB mode: one store serves both the durable bucket
            # files (persistence) and the indexed ledger-entry reads
            from ..bucket.manager import BucketListStore
            import tempfile
            bdir = config.BUCKET_DIR_PATH or (
                self.bucket_dir.path if self.bucket_dir is not None
                else tempfile.mkdtemp(prefix="bucketlistdb-"))
            self.bucket_store = BucketListStore(bdir)
            if self.bucket_dir is not None:
                self.bucket_dir = self.bucket_store

        invariants = (InvariantManager.from_patterns(config.INVARIANT_CHECKS)
                      if config.INVARIANT_CHECKS else None)

        # worker pool (reference: Application::postOnBackgroundThread /
        # WORKER_THREADS — bucket merges run here)
        from concurrent.futures import ThreadPoolExecutor
        self.worker_pool = (ThreadPoolExecutor(
            max_workers=config.WORKER_THREADS,
            thread_name_prefix="worker")
            if config.WORKER_THREADS > 0 else None)

        # ledger ------------------------------------------------------------
        cache_size = config.BUCKETLISTDB_ENTRY_CACHE_SIZE
        resident = config.BUCKET_RESIDENT_LEVELS
        if self.database is not None and self.database.get_state(
                PersistentState.LAST_CLOSED_LEDGER) is not None:
            self.lm = LedgerManager.load_last_known_ledger(
                self.network_id, self.database, self.bucket_dir,
                invariant_manager=invariants,
                bucket_store=self.bucket_store,
                entry_cache_size=cache_size,
                resident_levels=resident)
            self.lm.bucket_list.executor = self.worker_pool
        else:
            self.lm = LedgerManager(self.network_id,
                                    invariant_manager=invariants,
                                    merge_executor=self.worker_pool,
                                    bucket_store=self.bucket_store,
                                    entry_cache_size=cache_size,
                                    resident_levels=resident)
            self.lm.start_new_ledger()
            if self.database is not None:
                self.lm.enable_persistence(self.database, self.bucket_dir)

        self.lm.soroban_parallel_apply = config.SOROBAN_PARALLEL_APPLY

        # herder + overlay --------------------------------------------------
        self.herder = Herder(self.clock, self.lm, self.node_secret,
                             config.quorum_set(),
                             is_validator=config.NODE_IS_VALIDATOR)
        if self.database is not None:
            self.herder.attach_persistence(self.database)
        if config.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING:
            self.herder.ledger_timespan = 1.0
        if config.ADMISSION:
            # batched admission verification in front of the tx-queue
            # (herder/admission.py): /tx + overlay floods accumulate into
            # accel-sized batches; back-pressure feeds overlay flow
            # control (wired below) and /health
            self.herder.enable_admission(
                accel=self.accel, accel_device=self.accel_device,
                accel_chunk=config.ACCEL_CHUNK_SIZE,
                batch_size=config.ADMISSION_BATCH_SIZE,
                flush_delay_s=config.ADMISSION_FLUSH_DELAY_S,
                max_backlog=config.ADMISSION_MAX_BACKLOG)
        self.overlay = OverlayManager(
            self.clock, self.herder, self.network_id, self.node_secret,
            listening_port=config.PEER_PORT, database=self.database,
            batching=config.OVERLAY_BATCHING,
            batch_max_messages=config.OVERLAY_BATCH_MAX_MESSAGES,
            batch_max_bytes=config.OVERLAY_BATCH_MAX_BYTES)
        if self.herder.admission is not None:
            # backlog drained -> re-grant the flow-control capacity the
            # peers earned while the valve was closed
            self.herder.admission.on_backpressure_release = \
                self.overlay.release_flood_grants
        for addr in config.KNOWN_PEERS:
            host, _, port = addr.partition(":")
            self.overlay.peer_manager.add_address(host, int(port or 11625))
        self.transport: Optional[TCPTransport] = None
        if listen:
            self.transport = TCPTransport(
                self.overlay, listen_port=config.PEER_PORT)

        # history + catchup -------------------------------------------------
        from ..history.archive import make_archive
        archives = []
        for spec in config.HISTORY:
            archives.append(make_archive(spec.get_path, spec.put_path,
                                         spec.mkdir_cmd))
        self.history = HistoryManager(self.lm, config.NETWORK_PASSPHRASE,
                                      archives, database=self.database)
        if config.METADATA_OUTPUT_STREAM:
            self.lm.meta_stream = open(config.METADATA_OUTPUT_STREAM, "ab")
        self.herder.ledger_closed_hook = self._on_ledger_closed
        # native live close (ledger/native_close.py): the C apply engine
        # drives LedgerManager.close with NATIVE_CLOSE_DIFFERENTIAL
        # spot-checks; "auto" attaches when available, "on" warns loudly
        # when it cannot be honored
        if config.NATIVE_CLOSE != "off":
            attached = self.lm.attach_native_close(
                differential=config.NATIVE_CLOSE_DIFFERENTIAL or None)
            if attached:
                self.lm.native_closer.on_degrade = \
                    lambda reason: self.status.set_status("ledger", reason)
            elif config.NATIVE_CLOSE == "on":
                log.warning(
                    "NATIVE_CLOSE=on but the native close path is "
                    "unavailable (extension not built, BucketListDB root, "
                    "or INVARIANT_CHECKS enabled) — live close runs on the "
                    "~3x slower Python engine")
        # a node that falls behind pulls recent SCP state from its peers
        # (reference: HerderImpl out-of-sync recovery → getMoreSCPState);
        # beyond the peers' slot memory, archive catchup takes over
        self.herder.out_of_sync_handler = self._on_out_of_sync
        # a node that STARTS syncing (a restart, not the tracking ->
        # syncing edge) learns of a gap past the peers' slot memory only
        # from its buffered externalized values: the herder's sync-gap
        # hook hands that to archive catchup too, as a simulated node's
        # does (the reference's Application leaves the hook unset, so
        # such a node waits forever)
        self.herder.sync_gap_hook = self.maybe_start_archive_catchup
        self._catchup_work = None
        self.catchup = CatchupManager(
            self.network_id, config.NETWORK_PASSPHRASE,
            accel=self.accel, accel_device=self.accel_device,
            accel_chunk=config.ACCEL_CHUNK_SIZE,
            bucket_store=self.bucket_store,
            entry_cache_size=cache_size,
            resident_levels=resident)

        # maintenance -------------------------------------------------------
        from .maintainer import Maintainer
        self.maintainer = Maintainer(self)

        # retrospective telemetry -------------------------------------------
        # time-series capture + adaptive anomaly baselines.  Both run on
        # the observability plane OUTSIDE detguard regions: a VirtualTimer
        # on the crank loop under VIRTUAL_TIME (tests drive them
        # deterministically), a wall-cadence daemon thread on real nodes.
        self.timeseries = None
        self._ts_timer = None
        self.anomaly = None
        self._anomaly_timer = None
        if config.TIMESERIES_CADENCE_S > 0:
            from ..util.timeseries import TimeSeriesStore
            self.timeseries = TimeSeriesStore(
                cadence_s=config.TIMESERIES_CADENCE_S)
            if self.clock.mode is ClockMode.VIRTUAL_TIME:
                self._arm_ts_timer()
            else:
                self.timeseries.start()
            eventlog.register_bundle_source(
                "timeseries", lambda: _timeseries_bundle(ref()))
        if config.ANOMALY_EVAL_CADENCE_S > 0:
            from ..util.anomaly import AnomalyDetector, default_tracked
            self.anomaly = AnomalyDetector(
                default_tracked(),
                timeseries=lambda: _app_timeseries(ref()),
                closecosts=lambda: _app_closecosts(ref()),
                source=config.NODE_NAME or "local")
            self._arm_anomaly_timer()
            eventlog.register_bundle_source(
                "anomaly", lambda: _anomaly_bundle(ref()))
            if self.slo_tracker is not None:
                # leading indicator: /slo reports active anomalies before
                # the burn budget trips
                self.slo_tracker.attach_anomaly_source(self.anomaly.active)

        # http admin --------------------------------------------------------
        self.http = None
        if config.HTTP_PORT:
            from .http_admin import CommandHandler
            self.http = CommandHandler(self, config.HTTP_PORT)

        self._stopped = False

    # -- lifecycle -----------------------------------------------------------
    def _on_ledger_closed(self, arts) -> None:
        self.history.ledger_closed(arts)
        self.overlay.clear_below(
            max(0, self.lm.last_closed_ledger_seq - 100))
        # recovery clears the out-of-sync status line (reference:
        # StatusManager newest-status-per-category, removed on recovery)
        from ..herder.herder import HerderState
        if self.herder.state == HerderState.TRACKING:
            self.status.clear_status("scp")

    def _on_out_of_sync(self) -> None:
        self.status.set_status(
            "scp", f"out of sync at ledger "
            f"{self.lm.last_closed_ledger_seq}; requesting SCP state")
        self.overlay.request_scp_state()
        self.maybe_start_archive_catchup()

    def maybe_start_archive_catchup(self) -> None:
        """In-place archive catchup when the gap exceeds what peers can
        replay from SCP memory (reference: HerderImpl out-of-sync →
        CatchupManager::startCatchup; the herder keeps buffering
        externalized values meanwhile and _drain_buffered applies them
        once the replay closes the gap — ApplyBufferedLedgersWork)."""
        from ..herder.herder import MAX_SLOTS_TO_REMEMBER
        if self._catchup_work is not None and not self._catchup_work.done:
            return
        if not self.history.archives:
            return
        has = self.history.archives[0].get_state()
        if has is None:
            return
        gap = has.current_ledger - self.lm.last_closed_ledger_seq
        if gap <= MAX_SLOTS_TO_REMEMBER:
            return  # peers' SCP state covers it
        from ..historywork.works import CatchupWork
        log.info("starting in-place archive catchup: lcl=%d archive=%d",
                 self.lm.last_closed_ledger_seq, has.current_ledger)
        if self.lm.native_closer is not None:
            # the replay needs Python authority over the manager state;
            # closes during the gap run on the Python engine and the
            # native closer re-imports once the replay lands (_watch)
            self.lm.native_closer.deactivate()
        self.status.set_status(
            "history-catchup",
            f"catching up from archive: lcl={self.lm.last_closed_ledger_seq}"
            f" target={has.current_ledger}")
        work = CatchupWork(self.clock, self.lm,
                           self.history.archives[0], has.current_ledger,
                           self.network_id,
                           accel=self.accel,
                           accel_device=self.accel_device,
                           accel_chunk=self.config.ACCEL_CHUNK_SIZE,
                           stats=self.catchup.stats)
        self._catchup_work = work
        work.start()
        self._watch_catchup()

    def _watch_catchup(self) -> None:
        """Poll the catchup DAG from the crank loop; on completion, drain
        any live ledgers the herder buffered during the replay."""
        from ..util.clock import VirtualTimer
        if not self._catchup_work.done:
            t = VirtualTimer(self.clock)
            self._catchup_watch_timer = t
            t.expires_from_now(0.2, self._watch_catchup)
            return
        ok = self._catchup_work.succeeded
        log.info("archive catchup %s at lcl=%d",
                 "complete" if ok else "FAILED",
                 self.lm.last_closed_ledger_seq)
        if ok:
            self.status.clear_status("history-catchup")
        else:
            self.status.set_status(
                "history-catchup",
                f"archive catchup FAILED at "
                f"lcl={self.lm.last_closed_ledger_seq}")
        self._catchup_work = None
        closer = self.lm.native_closer
        if closer is not None and closer.degraded is None \
                and not closer.bridge.active:
            closer.activate()       # resume native close post-catchup
        self.herder._drain_buffered()

    def start(self) -> None:
        """Reference: ApplicationImpl::start — restore state, join
        consensus, dial peers."""
        self.herder.restore_scp_state()
        if self.http is not None:
            self.http.start()
        if self.config.RUN_STANDALONE or self.config.FORCE_SCP:
            self.herder.bootstrap()
        else:
            self.herder.start()
        self._dial_known_peers()
        self._start_reconnect_timer()
        self.maintainer.start()
        log.info("%s up: node=%s lcl=%d port=%d", VERSION,
                 self.node_secret.public_key.to_strkey()[:12],
                 self.lm.last_closed_ledger_seq,
                 self.overlay.listening_port)

    RECONNECT_INTERVAL = 2.0

    def _dial_known_peers(self) -> None:
        """Dial address-book candidates up to the target connection count
        (reference: OverlayManagerImpl::connectToMorePeers via
        RandomPeerSource)."""
        if self.transport is None:
            return
        want = self.config.TARGET_PEER_CONNECTIONS \
            - self.overlay.num_authenticated()
        if want <= 0:
            return
        exclude = self.overlay.connected_addresses()
        for host, port in self.overlay.peer_manager.dial_candidates(
                want, exclude=exclude):
            self.transport.connect(host, port)

    def _start_reconnect_timer(self) -> None:
        """Redial while under-connected (reference:
        OverlayManagerImpl::triggerPeerResolution on a timer).  Duplicate
        connections are resolved deterministically by the overlay's
        keep-smaller-dialer rule, so over-dialing is harmless."""
        from ..util.clock import VirtualTimer
        self._reconnect_timer = VirtualTimer(self.clock)

        def tick() -> None:
            self._dial_known_peers()
            self._reconnect_timer.expires_from_now(
                self.RECONNECT_INTERVAL, tick)

        self._reconnect_timer.expires_from_now(self.RECONNECT_INTERVAL, tick)

    def request_stop(self) -> None:
        """End run()'s crank loop after the current crank; the caller
        stops the node after run() returns (what `run`'s signal handler
        does, rather than stop() inside the handler)."""
        self._stopped = True

    def run(self) -> None:
        """The main crank loop (reference: ApplicationImpl::run /
        VirtualClock::crank in a loop until shutdown)."""
        import time
        while not self._stopped:
            if self.clock.crank() == 0:
                time.sleep(0.005)

    def _arm_slo_timer(self) -> None:
        """Repeating SLO evaluation on the clock loop (VirtualTimer so
        virtual-time tests crank it deterministically)."""
        from ..util.clock import VirtualTimer
        t = VirtualTimer(self.clock)

        def tick() -> None:
            if self._stopped:
                return
            self.slo_tracker.evaluate()
            t.expires_from_now(self.config.SLO_EVAL_CADENCE_S, tick)

        t.expires_from_now(self.config.SLO_EVAL_CADENCE_S, tick)
        self._slo_timer = t

    def _arm_ts_timer(self) -> None:
        """Repeating time-series capture under VIRTUAL_TIME (real nodes
        use the store's own wall-cadence daemon instead).  Capture
        stamps virtual seconds so exported curves line up with the
        simulation's close cadence."""
        from ..util.clock import VirtualTimer
        t = VirtualTimer(self.clock)

        def tick() -> None:
            if self._stopped:
                return
            self.timeseries.capture(now=self.clock.now())
            t.expires_from_now(self.config.TIMESERIES_CADENCE_S, tick)

        t.expires_from_now(self.config.TIMESERIES_CADENCE_S, tick)
        self._ts_timer = t

    def _arm_anomaly_timer(self) -> None:
        """Repeating anomaly evaluation on the clock loop (same shape as
        the SLO timer; works under both clock modes)."""
        from ..util.clock import VirtualTimer
        t = VirtualTimer(self.clock)

        def tick() -> None:
            if self._stopped:
                return
            self.anomaly.evaluate()
            t.expires_from_now(self.config.ANOMALY_EVAL_CADENCE_S, tick)

        t.expires_from_now(self.config.ANOMALY_EVAL_CADENCE_S, tick)
        self._anomaly_timer = t

    def stop(self) -> None:
        self._stopped = True
        if self._slo_timer is not None:
            self._slo_timer.cancel()
        if self._ts_timer is not None:
            self._ts_timer.cancel()
        if self._anomaly_timer is not None:
            self._anomaly_timer.cancel()
        if self.timeseries is not None:
            self.timeseries.stop()
        if self.lm.native_closer is not None:
            # move ledger authority back to Python (rebuilds buckets and,
            # with a database attached, persists the final LCL durably)
            self.lm.detach_native_close()
        if self.herder.admission is not None:
            self.herder.admission.close()
        if self.lm.meta_stream is not None \
                and not callable(self.lm.meta_stream):
            self.lm.meta_stream.close()
            self.lm.meta_stream = None
        if self.http is not None:
            self.http.stop()
        if self.transport is not None:
            self.transport.close()
        if self.worker_pool is not None:
            self.lm.bucket_list.resolve_all_merges()
            self.worker_pool.shutdown(wait=True)
        if self.database is not None:
            self.database.close()

    # -- introspection (CommandHandler backend) ------------------------------
    def info(self) -> dict:
        return {
            "build": VERSION,
            "network": self.config.NETWORK_PASSPHRASE,
            "node": self.node_secret.public_key.to_strkey(),
            "state": self.herder.get_state_human(),
            "ledger": {
                "num": self.lm.last_closed_ledger_seq,
                "hash": self.lm.lcl_hash.hex(),
                "version": self.lm.lcl_header.ledgerVersion,
                "baseFee": self.lm.lcl_header.baseFee,
                "baseReserve": self.lm.lcl_header.baseReserve,
            },
            "peers": {
                "authenticated_count": self.overlay.num_authenticated(),
                "pending_count": len(self.overlay.pending_peers),
            },
            "protocol_version": self.lm.lcl_header.ledgerVersion,
            "accel": self.config.ACCEL,
            "status": self.status.status_lines(),
        }

    def health(self) -> dict:
        """/health backend — see main/status.evaluate_health."""
        from .status import evaluate_health
        return evaluate_health(self)

    def metrics(self) -> dict:
        from ..util.metrics import registry
        return {
            "registry": registry().snapshot(),
            "overlay": dict(self.overlay.stats),
            "herder": {
                "state": self.herder.get_state_human(),
                "tx_queue_size": self.herder.tx_queue.size,
            },
            "ledger": {
                "num": self.lm.last_closed_ledger_seq,
                "entries": self.lm.root.entry_count(),
            },
            "accel": self.accel_use(),
        }

    # the admission pipeline's counts a fleet reads per node process
    ACCEL_ADMISSION_STATS = ("submitted", "batches", "dispatch_groups",
                             "sigs_offloaded", "sigs_shipped", "sync_path",
                             "collect_fallbacks", "race_losses")

    def accel_use(self) -> dict:
        """Where this process verifies signatures, for /metrics: the
        config's ACCEL, the devices it resolved, whether this process
        opened a CUDA context, the verify kernels it launched so far, and
        its admission pipeline's counts (``dispatch_groups`` counts the
        warm batch; ``warmed`` says its verdicts were taken).  With ACCEL
        "none" nothing but the setting and the pid."""
        out = {"pid": os.getpid(), "accel": self.config.ACCEL}
        if not self.accel:
            return out
        import torch
        from ..accel import ed25519, tables
        adm = self.herder.admission
        stats = adm.stats if adm is not None else {}
        out.update(
            devices=[str(d) for d in self.accel_devices],
            cuda_initialized=torch.cuda.is_initialized(),
            launches={"K-G": ed25519.verify_generic.launches,
                      "K-B": tables.build_tables_into.launches,
                      "K-T": tables.verify_tables.launches},
            admission=None if adm is None else dict(
                {k: stats.get(k, 0) for k in self.ACCEL_ADMISSION_STATS},
                warmed=adm._warmed, accel_min_sigs=adm.accel_min_sigs))
        return out

    def submit_tx(self, envelope_xdr: bytes) -> dict:
        """POST /tx backend (reference: CommandHandler::tx).  Malformed
        submissions surface as XDR/validation errors (XdrError IS-A
        ValueError) — the structured rejection path; anything else is a
        bug worth a loud traceback, not a silent ERROR reply.

        Thread contract: MAIN THREAD ONLY.  http_admin
        marshals /tx here via _on_main, so the whole admission chain
        (recv_transaction -> AdmissionPipeline.submit -> tx_queue.try_add)
        mutates queue state on the crank loop exclusively — that is the
        ownership the tx_queue/admission `owned-by=main` annotations
        attest and `make race` proves."""
        try:
            env = X.TransactionEnvelope.from_xdr(envelope_xdr)
            frame = self.lm.make_frame(env)
        except ValueError as e:
            log.debug("rejecting submitted tx: %s", e)
            return {"status": "ERROR", "detail": f"malformed: {e}"}
        res = self.herder.recv_transaction(frame)
        out = {"status": res.code.upper()}
        if res.result is not None:
            out["result_xdr"] = res.result.to_xdr().hex()
        return out

    def quorum_info(self, transitive: bool = False) -> dict:
        qmap = self.herder.quorum_map()
        out = {
            "node_count": len(qmap),
            "nodes": {k.hex()[:16]: (v is not None) for k, v in qmap.items()},
        }
        if transitive:
            from ..herder.quorum_intersection import check_intersection
            known = {k: v for k, v in qmap.items() if v is not None}
            if known:
                res = check_intersection(known)
                out["intersection"] = {
                    "intersects": res.intersects,
                    "node_count": len(known),
                }
        return out

    # -- admin-endpoint backends (reference: CommandHandler actions) ---------
    def manual_close(self) -> dict:
        """Trigger the next consensus round immediately.  Gated exactly
        like the reference (`CommandHandler::manualClose` requires
        MANUAL_CLOSE or RUN_STANDALONE) — on a live validator an admin
        trigger would race the herder's own ledger timer for the slot."""
        if not (self.config.MANUAL_CLOSE or self.config.RUN_STANDALONE):
            return {"status": "ERROR",
                    "detail": "manualclose requires MANUAL_CLOSE or "
                              "RUN_STANDALONE"}
        seq = self.lm.last_closed_ledger_seq + 1
        self.herder.trigger_next_ledger(seq)
        return {"status": "triggered", "ledger": seq}

    def connect_to(self, host: str, port: int) -> dict:
        if self.transport is None:
            return {"status": "ERROR", "detail": "node not listening"}
        self.overlay.peer_manager.add_address(host, port)
        self.transport.connect(host, port)
        return {"status": "connecting", "peer": f"{host}:{port}"}

    def drop_peer(self, node_id: bytes) -> dict:
        peer = self.overlay.authenticated_peers.get(node_id)
        if peer is None:
            return {"status": "ERROR", "detail": "no such peer"}
        peer.drop("dropped by admin")
        return {"status": "dropped"}

    def self_check(self) -> dict:
        from .selfcheck import self_check
        return self_check(self.lm, self.database, self.bucket_dir,
                          self.history.archives)

    def survey_node(self, node_id=None) -> dict:
        """Start a time-sliced survey; with a node id, also request that
        node's topology data."""
        if self.overlay.survey._nonce is None:
            nonce = self.overlay.survey.start_survey()
        else:
            nonce = self.overlay.survey._nonce
        if node_id is not None:
            self.overlay.survey.send_request(node_id)
        return {"status": "surveying", "nonce": nonce}

    def stop_survey(self) -> dict:
        self.overlay.survey.stop_survey()
        return {"status": "stopped"}

    def get_ledger_entry(self, key_bytes: bytes) -> dict:
        """`/getledgerentry` (reference: QueryServer getledgerentry) —
        served from an immutable bucket-list snapshot."""
        snap = self.lm.bucket_list.snapshot(self.lm.last_closed_ledger_seq)
        entry = snap.load(key_bytes)
        if entry is None:
            return {"found": False, "ledger": snap.ledger_seq}
        return {"found": True, "ledger": snap.ledger_seq,
                "entry_xdr": entry.to_xdr().hex()}
