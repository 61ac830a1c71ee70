"""Range-parallel catchup: N concurrent checkpoint ranges stitched by
assume-state.

The survey's history design (PAPER.md §2 rows 17-19: one HAS per
checkpoint, per-bucket hashes, `catchup_minimal` assume-state) makes every
checkpoint range independently seedable: worker k assumes the hash-verified
bucket snapshot at checkpoint k·R into its own BucketListDB dir, replays
its R checkpoints with full signature/tx-set/bucket verification, and
reports its final ledger header.  The stitch is PROVEN, not assumed —
range k's final ledger hash must equal range k+1's seed header hash (the
same 32 bytes the worker verified the assumed bucket list against), so the
concatenation of verified ranges is exactly the single-stream replay:

    range 0: genesis ──replay──▶ H(c_1)   ═╗ equal, or fail-stop
    range 1: assume c_1 [hash H(c_1)] ─────╝ ──replay──▶ H(c_2) ═╗
    range 2: assume c_2 [hash H(c_2)] ──────────────────────────╝ ─▶ ...

Workers are real subprocesses
(`python -m stellar_core_tpu_torch catchup-range`)
driven by util/process.ProcessManager — ranges get genuine CPU parallelism
past the GIL, and each worker's own PreverifyPipeline keeps the accel path
live per range.  Results travel through JSON files; a failed or corrupt
range retries with the Work framework's standard truncated-exponential
backoff (the same machinery the single-stream per-checkpoint download
uses), and any stitch mismatch fail-stops the whole catchup with a crash
bundle naming the offending boundary — the node's authoritative ledger dir
is only ever written AFTER every boundary has verified.

Reference sequencing: src/catchup/CatchupWork.cpp runs ApplyBucketsWork
once, then ApplyCheckpointWork strictly sequentially; this module runs N
CatchupWork-shaped pipelines whose ApplyBuckets seeds are interior
checkpoints, then proves the seams.

Additions:

* **Device-per-range mesh** — with ``mesh_devices=N`` each worker's env
  pins it to one card round-robin (accel/mesh.py), threaded through
  the subprocess cmdline like the PYTHONPATH pin, so N ranges × N devices
  multiply instead of contending for chip 0.
* **Checkpoint-granular work stealing** — a parallel catchup's rate is
  capped by the straggler range.  Each worker heartbeats its LCL into a
  control dir (``ctl-XX/progress.json``, survives retry wipes of the
  range dir); when a worker finishes, the orchestrator picks the slowest
  running range, splits its REMAINING checkpoints at a published boundary
  (plan_steal: the thief adopts the later half), and negotiates via a
  limit/ack handshake: the victim's CatchupWork truncates its target at
  the split boundary ONLY after writing an explicit accept ack, and the
  thief subprocess (seeded at the split via assume-state, like any range)
  is spawned only after that ack — so the seam is deterministic even
  though progress races the negotiation.  verify_stitches proves the
  dynamically-split seams exactly like the planned ones; a forged steal
  seam fail-stops the whole catchup with a crash bundle.
"""

from __future__ import annotations

import json
import os
import shlex
import shutil
import sys
import time as _time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..history.archive import (checkpoint_containing, checkpoint_frequency,
                               make_archive)
from ..util import eventlog
from ..util import logging as slog
from ..util.clock import ClockMode, VirtualClock
from ..util.metrics import registry as _registry
from ..util.process import ProcessManager
from ..util.racetrace import race_checked
from ..work.work import RETRY_A_FEW, BasicWork, State
from .catchup import CatchupError

log = slog.get("History")


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RangeSpec:
    """One contiguous checkpoint range of a parallel catchup plan.

    ``seed_checkpoint`` is the published boundary whose bucket snapshot the
    worker assumes before replaying (None = range 0, which replays from
    genesis); ``replay_to`` is the last ledger the range applies (a
    checkpoint boundary for every range but possibly the last)."""
    index: int
    seed_checkpoint: Optional[int]
    replay_to: int

    @property
    def replay_from(self) -> int:
        return 2 if self.seed_checkpoint is None else self.seed_checkpoint + 1

    @property
    def n_ledgers(self) -> int:
        return self.replay_to - self.replay_from + 1


def remaining_checkpoint_units(progress: int, replay_to: int) -> int:
    """How many checkpoint-granular work units are left in (progress,
    replay_to]: one per published boundary plus the partial tail (when
    replay_to is not itself a boundary)."""
    if replay_to <= progress:
        return 0
    freq = checkpoint_frequency()
    boundaries = [b for b in range(freq - 1, replay_to + 1, freq)
                  if b > progress]
    tail = 0 if boundaries and boundaries[-1] == replay_to else 1
    return len(boundaries) + tail


def plan_steal(progress: int, replay_to: int) -> Optional[int]:
    """Split the remaining (progress, replay_to] work of a straggler range
    at a published checkpoint boundary.  Returns the boundary the victim
    stops at — the thief seeds there via assume-state and replays
    (boundary, replay_to] — or None when fewer than two units remain.
    The thief adopts HALF the remaining checkpoints (rounded down), the
    LATER half, so the victim never rewinds; seams stay
    checkpoint-aligned because only published boundaries are split
    points."""
    freq = checkpoint_frequency()
    candidates = [b for b in range(freq - 1, replay_to, freq)
                  if b > progress]
    if not candidates:
        return None
    total_units = remaining_checkpoint_units(progress, replay_to)
    steal_units = total_units // 2
    if steal_units < 1:
        return None
    keep_units = total_units - steal_units
    # the victim keeps units 1..keep: its new end is the keep-th boundary
    return candidates[keep_units - 1]


def _write_json_atomic(path: str, doc: dict) -> None:
    """Both halves of the steal handshake write through here — a torn
    limit/ack would desynchronize the seam negotiation."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


@race_checked
class RangeControl:
    """The worker-side half of the stealing protocol, rooted in a control
    dir that OUTLIVES retry wipes of the range dir:

    * ``progress.json`` — heartbeat: the LCL after every applied
      checkpoint (and the throttle seam for straggler-injection tests:
      STPU_CATCHUP_THROTTLE_S sleeps that long per checkpoint).
    * ``limit.json`` — orchestrator-written steal limit: a published
      boundary this range should stop at.
    * ``limit-ack.json`` — the worker's verdict.  ``accepted`` means the
      worker WILL stop exactly at the limit (its CatchupWork target is
      truncated); ``rejected`` means progress already passed it.  The
      orchestrator spawns the thief only on an accept, so a lost race
      never tears a seam.
    """

    PROGRESS = "progress.json"
    LIMIT = "limit.json"
    ACK = "limit-ack.json"

    def __init__(self, ctl_dir: str, throttle_s: Optional[float] = None):
        os.makedirs(ctl_dir, exist_ok=True)
        self.dir = ctl_dir
        # Thread contract: cross-WORKER coordination
        # rides exclusively in the atomically-replaced JSON files; these
        # in-process latches are only ever touched by the range worker's
        # single replay thread (checkpoint_hook), attested below and
        # enforced at runtime by @race_checked under make race.
        self.accepted: Optional[int] = None  # corelint: owned-by=main -- steal-limit accept latch, written once by checkpoint_hook on the replay thread
        self._rejected = False  # corelint: owned-by=main -- sticky reject latch, checkpoint_hook only
        if throttle_s is None:
            throttle_s = float(
                os.environ.get("STPU_CATCHUP_THROTTLE_S", "0") or 0.0)
        self.throttle_s = throttle_s

    def _write(self, name: str, doc: dict) -> None:
        _write_json_atomic(os.path.join(self.dir, name), doc)

    def _read(self, name: str) -> Optional[dict]:
        return _read_json(os.path.join(self.dir, name))

    def checkpoint_hook(self, lcl: int) -> Optional[int]:
        """CatchupWork hook: heartbeat + honor at most one steal limit.
        Returns the accepted boundary (the truncated target) or None."""
        if self.throttle_s:
            _time.sleep(self.throttle_s)
        self._write(self.PROGRESS, {"lcl": lcl})
        if self.accepted is not None or self._rejected:
            return self.accepted
        lim = self._read(self.LIMIT)
        if lim is None:
            return None
        boundary = int(lim["replay_to"])
        if boundary >= lcl:
            self.accepted = boundary
            self._write(self.ACK, {"accepted": boundary})
            eventlog.record("History", "INFO", "steal limit accepted",
                            boundary=boundary, lcl=lcl)
            return boundary
        self._rejected = True
        self._write(self.ACK, {"rejected": lcl})
        eventlog.record("History", "INFO", "steal limit rejected",
                        boundary=boundary, lcl=lcl)
        return None


def plan_parallel_ranges(target: int, workers: int) -> List[RangeSpec]:
    """Split the checkpoints covering (genesis, target] into up to
    `workers` contiguous ranges.  Every interior seam sits on a published
    checkpoint boundary so range k+1 can seed itself from the archive's
    per-checkpoint HAS; ranges are balanced to within one checkpoint."""
    if target < 2:
        raise CatchupError(f"nothing to replay to ledger {target}")
    if workers < 1:
        raise CatchupError(f"workers must be >= 1, got {workers}")
    freq = checkpoint_frequency()
    last_cp = checkpoint_containing(target)
    boundaries = list(range(freq - 1, last_cp + 1, freq))
    n = max(1, min(workers, len(boundaries)))
    base, rem = divmod(len(boundaries), n)
    specs: List[RangeSpec] = []
    seed: Optional[int] = None
    start = 0
    for k in range(n):
        size = base + (1 if k < rem else 0)
        end_cp = boundaries[start + size - 1]
        replay_to = target if k == n - 1 else min(end_cp, target)
        specs.append(RangeSpec(index=k, seed_checkpoint=seed,
                               replay_to=replay_to))
        seed = end_cp
        start += size
    return specs


# ---------------------------------------------------------------------------
# the worker body (runs inside `python -m stellar_core_tpu_torch
# catchup-range`)
# ---------------------------------------------------------------------------

def _verify_launches() -> Dict[str, int]:
    """Launches so far of the signature kernels the preverify pipeline
    runs: K-G (generic verify), K-B (key tables) and K-T (table verify)."""
    from ..accel import ed25519, tables
    return {"K-G": ed25519.verify_generic.launches,
            "K-B": tables.build_tables_into.launches,
            "K-T": tables.verify_tables.launches}


def run_range(archive, spec: RangeSpec, network_id: bytes, passphrase: str,
              *, accel: bool = False, accel_chunk: int = 8192,
              native: Optional[bool] = None,
              invariant_manager=None,
              bucket_dir: Optional[str] = None,
              entry_cache_size: Optional[int] = None,
              resident_levels: Optional[int] = None,
              persist_dir: Optional[str] = None,
              persist_target: Optional[int] = None,
              ctl_dir: Optional[str] = None,
              accel_profile: Optional[str] = None,
              accel_device=None,
              clock=None, lookahead: int = 2) -> dict:
    """Seed + replay one range and return its stitch record.  This is the
    in-process body of the `catchup-range` worker subcommand; tests drive
    it directly too.

    With `bucket_dir`, the range's assumed/replayed state lives in its own
    BucketListDB store there (throwaway for interior ranges).  With
    `persist_dir`, the final state is durably persisted (Database +
    BucketDir) so the orchestrator can adopt the last range's ledger —
    gated on `persist_target` when given: under work stealing whichever
    worker actually ENDS at the catchup target owns the adoptable state,
    and a truncated victim must not burn time persisting a mid-chain
    snapshot.  With `ctl_dir`, the worker heartbeats progress and honors
    steal limits (RangeControl).  `accel_device`: None is the card, "cpu"
    the plain versions (CatchupManager)."""
    from ..catchup.catchup import CatchupManager

    store = None
    if bucket_dir is not None:
        from ..bucket.manager import BucketListStore
        store = BucketListStore(bucket_dir)
    cm = CatchupManager(network_id, passphrase, accel=accel,
                        accel_chunk=accel_chunk, native=native,
                        invariant_manager=invariant_manager,
                        bucket_store=store,
                        entry_cache_size=entry_cache_size,
                        resident_levels=resident_levels,
                        accel_profile=accel_profile,
                        accel_device=accel_device)
    control = RangeControl(ctl_dir) if ctl_dir is not None else None
    launches0 = _verify_launches() if accel else None
    t0 = _time.perf_counter()
    mgr, seed_hash = cm.catchup_range(
        archive, spec.seed_checkpoint, spec.replay_to, clock=clock,
        lookahead=lookahead,
        checkpoint_hook=control.checkpoint_hook if control else None)
    wall = _time.perf_counter() - t0
    final_seq = mgr.last_closed_ledger_seq
    persisted = persist_dir is not None and (
        persist_target is None or final_seq == persist_target)
    if persisted:
        from ..bucket.manager import BucketDir
        from ..database import Database
        os.makedirs(persist_dir, exist_ok=True)
        db = Database(os.path.join(persist_dir, "state.db"))
        mgr.enable_persistence(db, BucketDir(
            os.path.join(persist_dir, "buckets")))
        db.close()
    n = final_seq - spec.replay_from + 1
    result = {
        "index": spec.index,
        "seed_checkpoint": spec.seed_checkpoint,
        "seed_header_hash": seed_hash.hex() if seed_hash is not None else None,
        "replay_to": spec.replay_to,
        "final_ledger_seq": final_seq,
        "final_hash": mgr.lcl_hash.hex(),
        "ledgers_replayed": n,
        "wall_s": round(wall, 3),
        "ledgers_per_s": round(n / wall, 1) if wall > 0 else 0.0,
        "sig_offload_hit_rate": round(cm.offload_hit_rate(), 3),
        "persisted": persisted,
    }
    if accel:
        # the verify kernels this range launched (none on the plain
        # versions): the record's proof that the range verified on the card
        result["launches"] = {k: n - launches0[k]
                              for k, n in _verify_launches().items()}
    if final_seq < spec.replay_to:
        result["truncated_to"] = final_seq   # a thief adopted the tail
    # read the pin straight from the env, as the reference does
    dev = os.environ.get("STPU_DEVICE_INDEX")
    if dev is not None and dev.isdigit():
        result["device_index"] = int(dev)
        if accel:
            # pinned accel worker: record how many cards torch sees (the
            # mesh env must have reduced them to exactly one)
            import torch
            result["visible_devices"] = torch.cuda.device_count()
    return result


# ---------------------------------------------------------------------------
# stitch proof
# ---------------------------------------------------------------------------

def range_summary(result: dict) -> str:
    """One line of a range's stitch record: the ledgers it replayed, its
    rate, the share of its signatures whose verdicts came from the
    device pipeline, and the verify kernels it launched (a JSON object;
    "none" where the range ran without accel).  The orchestrator logs it
    and the `catchup --parallel` command prints it, so a run's log holds
    the evidence of where each range verified without --report."""
    launches = result.get("launches")
    return (f"range {result['index']}: {result['ledgers_replayed']} "
            f"ledgers to {result['final_ledger_seq']} "
            f"({result['ledgers_per_s']} ledgers/s), offload hit rate "
            f"{result['sig_offload_hit_rate']}, launches "
            f"{json.dumps(launches, sort_keys=True) if launches else 'none'}")


def verify_stitches(results: List[dict],
                    crash_dir: Optional[str] = None) -> int:
    """Prove the seams: range k's final ledger (seq, hash) must equal range
    k+1's seed (checkpoint, header hash).  Each verified boundary counts on
    catchup.parallel.stitch-verified; any mismatch writes a crash bundle
    naming the boundary and raises CatchupError.  Returns the number of
    boundaries verified."""
    counter = _registry().counter("catchup.parallel.stitch-verified")
    verified = 0
    for a, b in zip(results, results[1:]):
        boundary = b["seed_checkpoint"]
        detail = None
        if a["final_ledger_seq"] != boundary:
            detail = (f"range {a['index']} ended at ledger "
                      f"{a['final_ledger_seq']}, range {b['index']} seeded "
                      f"at checkpoint {boundary}")
        elif a["final_hash"] != b["seed_header_hash"]:
            detail = (f"range {a['index']} final hash {a['final_hash']} != "
                      f"range {b['index']} seed header hash "
                      f"{b['seed_header_hash']}")
        if detail is not None:
            eventlog.record("History", "ERROR", "parallel catchup stitch "
                            "FAILED", boundary=boundary, detail=detail)
            eventlog.write_crash_bundle(
                f"parallel catchup stitch mismatch at checkpoint boundary "
                f"{boundary}: {detail}", crash_dir=crash_dir)
            raise CatchupError(
                f"stitch mismatch at checkpoint boundary {boundary}: "
                f"{detail}")
        counter.inc()
        verified += 1
        eventlog.record("History", "INFO", "stitch verified",
                        boundary=boundary,
                        hash=a["final_hash"][:16])
    return verified


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

class RangeWork(BasicWork):
    """One range's subprocess, as a Work: on_run launches the worker via
    ProcessManager and WAITs; a non-zero exit or an unreadable result file
    is a FAILURE, which BasicWork retries with the single-stream catchup's
    truncated-exponential backoff (archive corruption is transient on real
    mirrors)."""

    def __init__(self, clock: VirtualClock, pm: ProcessManager,
                 cmdline: str, result_path: str, spec: RangeSpec,
                 log_path: Optional[str] = None,
                 workdir: Optional[str] = None,
                 max_retries: int = RETRY_A_FEW):
        super().__init__(clock, f"catchup-range-{spec.index}",
                         max_retries=max_retries)
        self.pm = pm
        self.cmdline = cmdline
        self.result_path = result_path
        self.log_path = log_path
        self.workdir = workdir
        self.spec = spec
        self.result: Optional[dict] = None
        self.error_detail: Optional[str] = None
        self._ev = None
        self._code: Optional[int] = None

    def on_reset(self) -> None:
        if self._ev is not None and self._ev.running:
            self.pm.cancel(self._ev)
        self._ev = None
        self._code = None

    def _on_exit(self, code: int) -> None:
        self._code = code
        self.wake_up()

    def on_run(self) -> State:
        if self._ev is None:
            if self.workdir is not None and self.retries > 0:
                # a crashed attempt can leave TORN range-private state
                # (half-written state.db, a bucketlistdb mid-adopt);
                # feeding it back in would turn a one-shot transient fault
                # into max_retries hard failures — every retry starts from
                # the pristine dir a fresh worker would get
                shutil.rmtree(self.workdir, ignore_errors=True)
                os.makedirs(self.workdir, exist_ok=True)
            try:
                os.unlink(self.result_path)   # stale result from a retry
            except FileNotFoundError:
                pass
            eventlog.record("History", "INFO", "range worker started",
                            range=self.spec.index,
                            replay_to=self.spec.replay_to,
                            attempt=self.retries + 1)
            self._ev = self.pm.run_command(self.cmdline, self._on_exit,
                                           output_path=self.log_path)
            return State.WAITING
        if self._code is None:
            return State.WAITING
        if self._code == 0:
            try:
                with open(self.result_path) as f:
                    result = json.load(f)
            except (OSError, ValueError) as e:
                self.error_detail = f"result file unreadable: {e}"
                log.warning("%s: %s", self.name, self.error_detail)
                _registry().counter("catchup.parallel.range-retry").inc()
                return State.FAILURE
            if "error" in result:
                self.error_detail = result["error"]
                log.warning("%s: worker error: %s", self.name,
                            self.error_detail)
                _registry().counter("catchup.parallel.range-retry").inc()
                return State.FAILURE
            self.result = result
            _registry().histogram("catchup.parallel.range-rate").update(
                result.get("ledgers_per_s", 0.0))
            eventlog.record("History", "INFO", "range worker finished",
                            range=self.spec.index,
                            final=result["final_ledger_seq"],
                            rate=result.get("ledgers_per_s", 0.0))
            return State.SUCCESS
        self.error_detail = f"worker exited {self._code}"
        self.error_detail += self._tail_of_log()
        log.warning("%s: %s", self.name, self.error_detail)
        _registry().counter("catchup.parallel.range-retry").inc()
        return State.FAILURE

    def _tail_of_log(self) -> str:
        if self.log_path is None:
            return ""
        try:
            with open(self.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - 800))
                tail = f.read().decode(errors="replace").strip()
            return f"; log tail: {tail[-400:]}" if tail else ""
        except OSError:
            return ""


class ParallelCatchup:
    """Plan, fan out, stitch, adopt.

    ``run()`` splits the archive's chain into up to `workers` contiguous
    checkpoint ranges, replays them as bounded-concurrency subprocess
    workers (each seeding itself via assume-state into a throwaway
    BucketListDB dir under `workdir`), proves every boundary, and returns
    the report.  The LAST range persists its state; ``load_manager()``
    rebuilds the node's LedgerManager from it, and ``adopt_into()`` moves
    it to the node's authoritative paths — both only reachable after the
    stitch proof, so a poisoned range can never touch the real ledger."""

    def __init__(self, archive_spec: str, passphrase: str, *,
                 workers: int = 4, workdir: Optional[str] = None,
                 accel: bool = False, accel_chunk: int = 8192,
                 native: Optional[bool] = None,
                 invariant_checks: Optional[List[str]] = None,
                 in_memory: bool = False,
                 entry_cache_size: Optional[int] = None,
                 resident_levels: Optional[int] = None,
                 max_retries: int = RETRY_A_FEW,
                 keep_range_dirs: bool = False,
                 crash_dir: Optional[str] = None,
                 clock: Optional[VirtualClock] = None,
                 steal: bool = True,
                 steal_min_checkpoints: int = 4,
                 mesh_devices: int = 0,
                 mesh_platform: str = "auto",
                 accel_profile: Optional[str] = None,
                 accel_device=None,
                 extra_env: Optional[Dict[int, Dict[str, str]]] = None,
                 python: str = sys.executable):
        from ..crypto.sha import sha256
        self.archive_spec = archive_spec
        self.passphrase = passphrase
        self.network_id = sha256(passphrase.encode())
        self.workers = max(1, workers)
        self._own_workdir = workdir is None
        if workdir is None:
            import tempfile
            workdir = tempfile.mkdtemp(prefix="catchup-par-")
        self.workdir = workdir
        self.accel = accel
        self.accel_chunk = accel_chunk
        # the workers' device: None is the card (`--accel cuda`), "cpu"
        # the plain versions (`--accel cpu`); with neither, the pipeline's
        # DEFAULT_DEVICE, so a process that pinned it pins its workers too
        if accel_device is None:
            from .catchup import PreverifyPipeline
            accel_device = PreverifyPipeline.DEFAULT_DEVICE
        if accel_device not in (None, "cpu", "cuda"):
            raise ValueError(f"workers take accel_device None, 'cuda' or "
                             f"'cpu', not {accel_device!r}")
        self.accel_device = accel_device
        self.native = native
        # checkpoint-granular work stealing (module docstring): finished
        # workers adopt the later half of the slowest range's remaining
        # checkpoints; only remainders >= steal_min_checkpoints units are
        # worth a worker spawn + assume-state
        self.steal = steal
        self.steal_min_checkpoints = max(2, steal_min_checkpoints)
        # device-per-range mesh: > 0 pins worker k to device k % N via
        # env (accel/mesh.py), threaded through the subprocess cmdline
        self.mesh_devices = max(0, mesh_devices)
        self.mesh_platform = mesh_platform
        self.accel_profile = accel_profile
        # per-range-index env additions (tests inject stragglers with
        # STPU_CATCHUP_THROTTLE_S; the mesh pin composes on top)
        self.extra_env = dict(extra_env or {})
        # INVARIANT_CHECKS patterns travel to every worker — a parallel
        # catchup must honor exactly what the single-stream path would;
        # same for the node's storage knobs (IN_MEMORY_LEDGER + the
        # BucketListDB cache/residency bounds, which matter MOST when N
        # workers share the box's memory)
        self.invariant_checks = list(invariant_checks or [])
        self.in_memory = in_memory
        self.entry_cache_size = entry_cache_size
        self.resident_levels = resident_levels
        self.max_retries = max_retries
        self.keep_range_dirs = keep_range_dirs
        self.crash_dir = crash_dir
        self.clock = clock or VirtualClock(ClockMode.REAL_TIME)
        self.python = python
        self.report: Optional[dict] = None
        self._final_dir: Optional[str] = None
        self._target: Optional[int] = None

    # -- worker command ----------------------------------------------------
    def _range_dir(self, index: int) -> str:
        return os.path.join(self.workdir, f"range-{index:02d}")

    def _ctl_dir(self, index: int) -> str:
        # OUTSIDE the range dir: RangeWork wipes the range dir on retry,
        # and an accepted steal limit must survive the wipe or the fresh
        # attempt would replay past the split boundary and tear the seam
        return os.path.join(self.workdir, f"ctl-{index:02d}")

    def _worker_cmdline(self, spec: RangeSpec) -> str:
        d = self._range_dir(spec.index)
        # workers must import the SAME package the parent runs, even when
        # the parent got it via sys.path manipulation (an embedding
        # consumer) rather than cwd or an inherited PYTHONPATH — without
        # this every range worker dies on ImportError and the retry
        # backoff turns a config quirk into minutes of spin
        pkg_parent = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        inherited = os.environ.get("PYTHONPATH")
        pythonpath = pkg_parent if not inherited \
            else pkg_parent + os.pathsep + inherited
        args = [self.python, "-m", "stellar_core_tpu_torch", "catchup-range",
                "--archive", self.archive_spec,
                "--passphrase", self.passphrase,
                "--to", str(spec.replay_to),
                "--seed-checkpoint",
                ("genesis" if spec.seed_checkpoint is None
                 else str(spec.seed_checkpoint)),
                "--workdir", d,
                "--result", os.path.join(d, "result.json")]
        args += ["--index", str(spec.index)]
        # whichever worker ends at the catchup target owns the adoptable
        # state (under stealing that may be a thief, not the planned last
        # range) — every worker gets the target and self-selects
        if self._target is not None:
            args += ["--persist-target", str(self._target)]
        # the control dir rides along even with stealing off: the
        # progress heartbeat is the orchestrator's visibility into a
        # straggling range (and the throttle seam must behave identically
        # in steal-on vs steal-off comparisons)
        args += ["--ctl-dir", self._ctl_dir(spec.index)]
        if self.accel:
            args += ["--accel",
                     "cpu" if self.accel_device == "cpu" else "cuda",
                     "--accel-chunk",
                     str(self.accel_chunk)]
        if self.accel_profile is not None:
            args += ["--accel-profile", self.accel_profile]
        if self.native is not None:
            args += ["--native", "on" if self.native else "off"]
        for pattern in self.invariant_checks:
            args += ["--invariant", pattern]
        if self.in_memory:
            args.append("--in-memory")
        if self.entry_cache_size is not None:
            args += ["--entry-cache-size", str(self.entry_cache_size)]
        if self.resident_levels is not None:
            args += ["--resident-levels", str(self.resident_levels)]
        if checkpoint_frequency() != 64:
            # non-default cadence (accelerated test fleets) must reach the
            # worker process or its range plan/seam math disagrees with ours
            args += ["--checkpoint-frequency", str(checkpoint_frequency())]
        # ProcessManager runs shell-less (shlex.split + Popen), so the
        # assignments travel through `env`: PYTHONPATH, the per-worker
        # device pin (mesh), and any per-range test env
        env_pairs = {"PYTHONPATH": pythonpath}
        if self.mesh_devices > 0:
            from ..accel import mesh as _mesh
            env_pairs.update(_mesh.worker_device_env(
                spec.index % self.mesh_devices, self.mesh_devices,
                self.mesh_platform))
        env_pairs.update(self.extra_env.get(spec.index, {}))
        args = ["env"] + [f"{k}={v}" for k, v in env_pairs.items()] + args
        return " ".join(shlex.quote(a) for a in args)

    # -- work stealing -----------------------------------------------------
    def _make_work(self, pm: ProcessManager, spec: RangeSpec) -> RangeWork:
        d = self._range_dir(spec.index)
        os.makedirs(d, exist_ok=True)
        # a reused workdir may hold a PREVIOUS run's steal artifacts
        # (limit/ack from an interrupted catchup): a worker honoring a
        # stale limit would truncate with no thief to cover the tail.
        # Control state is strictly per-run; only the RETRY path within a
        # run must preserve it (RangeWork wipes the range dir, not this).
        shutil.rmtree(self._ctl_dir(spec.index), ignore_errors=True)
        return RangeWork(
            self.clock, pm, self._worker_cmdline(spec),
            os.path.join(d, "result.json"), spec,
            log_path=os.path.join(d, "worker.log"),
            workdir=d,
            max_retries=self.max_retries)

    def _read_ctl(self, index: int, name: str) -> Optional[dict]:
        return _read_json(os.path.join(self._ctl_dir(index), name))

    def _progress_of(self, w: RangeWork) -> int:
        """The victim candidate's last heartbeat LCL (its seed when no
        checkpoint has completed yet — stealable from the start)."""
        doc = self._read_ctl(w.spec.index, RangeControl.PROGRESS)
        if doc is not None and isinstance(doc.get("lcl"), int):
            return max(doc["lcl"], w.spec.seed_checkpoint or 1)
        return w.spec.seed_checkpoint or 1

    def _spawn_thief(self, pm, works, victim: RangeWork,
                     boundary: int) -> None:
        """The accepted half of the handshake: the victim WILL stop at
        `boundary`; seed a thief there covering the abandoned tail."""
        spec = RangeSpec(index=self._next_index,
                         seed_checkpoint=boundary,
                         replay_to=self._expected_to[victim])
        self._next_index += 1
        self._expected_to[victim] = boundary
        thief = self._make_work(pm, spec)
        self._expected_to[thief] = spec.replay_to
        works.append(thief)
        thief.start()
        adopted = remaining_checkpoint_units(boundary, spec.replay_to)
        self._steal_events.append({
            "victim": victim.spec.index, "thief": spec.index,
            "boundary": boundary, "checkpoints_adopted": adopted})
        _registry().counter("catchup.parallel.steal").inc()
        eventlog.record("History", "INFO", "checkpoint steal",
                        victim=victim.spec.index, thief=spec.index,
                        boundary=boundary, adopted=adopted)
        log.info("work steal: range %d adopts %d checkpoint(s) of range "
                 "%d past boundary %d", spec.index, adopted,
                 victim.spec.index, boundary)

    def _maybe_steal(self, pm, works: List[RangeWork]) -> None:
        """One crank of the steal state machine: settle the outstanding
        negotiation (spawn the thief on an accept), then — with spare
        worker capacity and no negotiation in flight — pick the slowest
        running range and write it a limit at the plan_steal boundary."""
        # settle the in-flight negotiation first (at most one at a time:
        # seams are serialized so the stitch chain stays a chain)
        if self._negotiation is not None:
            victim, boundary = self._negotiation
            ack = self._read_ctl(victim.spec.index, RangeControl.ACK)
            if ack is not None and ack.get("accepted") == boundary:
                self._negotiation = None
                self._spawn_thief(pm, works, victim, boundary)
            elif ack is not None:
                self._negotiation = None   # progress won the race
            elif victim.done:
                self._negotiation = None
                if victim.succeeded and victim.result is not None \
                        and victim.result["final_ledger_seq"] == boundary:
                    # it honored the limit but the ack read raced its exit
                    self._spawn_thief(pm, works, victim, boundary)
            return
        active = [w for w in works if not w.done]
        if not active or len(active) >= self.workers \
                or not any(w.done and w.succeeded for w in works):
            return
        candidates = []
        for w in active:
            if w in self._victimized:
                continue
            progress = self._progress_of(w)
            units = remaining_checkpoint_units(progress,
                                               self._expected_to[w])
            if units >= self.steal_min_checkpoints:
                candidates.append((units, progress, w))
        if not candidates:
            return
        units, progress, victim = max(candidates, key=lambda c: c[0])
        boundary = plan_steal(progress, self._expected_to[victim])
        if boundary is None:
            return
        ctl = self._ctl_dir(victim.spec.index)
        os.makedirs(ctl, exist_ok=True)
        _write_json_atomic(os.path.join(ctl, RangeControl.LIMIT),
                           {"replay_to": boundary})
        self._victimized.add(victim)
        self._negotiation = (victim, boundary)
        eventlog.record("History", "INFO", "steal limit offered",
                        victim=victim.spec.index, boundary=boundary,
                        remaining_units=units)

    # -- driving -----------------------------------------------------------
    def run(self, target: Optional[int] = None) -> dict:
        archive = make_archive(self.archive_spec)
        has = archive.get_state()
        if has is None:
            raise CatchupError("archive has no HAS")
        if target is None:
            target = has.current_ledger
        self._target = target
        self._specs = plan_parallel_ranges(target, self.workers)
        if len(self._specs) == 1:
            log.info("parallel catchup degenerates to a single range "
                     "(target %d)", target)
        pm = ProcessManager(self.clock, max_concurrent=self.workers)
        works: List[RangeWork] = [self._make_work(pm, spec)
                                  for spec in self._specs]
        # steal bookkeeping: each work's CURRENT end (shrinks when stolen
        # from), the outstanding limit negotiation, spawned thieves
        self._expected_to = {w: w.spec.replay_to for w in works}
        self._victimized: set = set()
        self._negotiation = None
        self._steal_events: List[dict] = []
        self._next_index = len(self._specs)
        inflight = _registry().gauge("catchup.parallel.ranges-inflight")
        inflight.set_source(lambda: sum(1 for w in works if not w.done))
        eventlog.record("History", "INFO", "parallel catchup started",
                        target=target, ranges=len(self._specs),
                        workers=self.workers, steal=self.steal)
        t0 = _time.perf_counter()
        last_steal_check = 0.0
        for w in works:
            w.start()
        try:
            while True:
                if self.steal and len(works) > 1:
                    now = _time.perf_counter()
                    # an outstanding negotiation is settled EVERY
                    # iteration: a victim that accepts and exits right
                    # before the run drains must still get its thief
                    # spawned, or the stolen tail is replayed by nobody
                    if self._negotiation is not None \
                            or now - last_steal_check >= 0.1:
                        last_steal_check = now
                        self._maybe_steal(pm, works)
                if all(w.done for w in works) \
                        and self._negotiation is None:
                    break
                if self.clock.crank() == 0:
                    # REAL_TIME + subprocesses still running: yield the
                    # host instead of spinning the poll pump
                    _time.sleep(0.02)
        finally:
            pm.shutdown()
            # drop the closure over `works` (the registry is
            # process-global; a stale source would pin every RangeWork)
            inflight.set_source(lambda: 0)
        wall = _time.perf_counter() - t0
        failed = [w for w in works if not w.succeeded]
        if failed:
            w = failed[0]
            detail = (f"range {w.spec.index} "
                      f"(replay to {w.spec.replay_to}) failed after "
                      f"{w.retries} retries: {w.error_detail or '?'}")
            eventlog.record("History", "ERROR",
                            "parallel catchup range FAILED",
                            range=w.spec.index, detail=w.error_detail or "?")
            eventlog.write_crash_bundle(
                f"parallel catchup range failure: {detail}",
                crash_dir=self.crash_dir)
            raise CatchupError(detail)
        # chain order by seed: steals splice thieves into the middle of
        # the plan, and verify_stitches proves consecutive seams
        works_by_seed = sorted(
            works, key=lambda w: (w.result["seed_checkpoint"]
                                  if w.result["seed_checkpoint"] is not None
                                  else -1))
        results = [w.result for w in works_by_seed]
        stitches = verify_stitches(results, crash_dir=self.crash_dir)
        final = results[-1]
        if final["final_ledger_seq"] != target:
            raise CatchupError(
                f"parallel catchup ended at {final['final_ledger_seq']}, "
                f"target {target}")
        if not final.get("persisted"):
            raise CatchupError(
                f"range {final['index']} reached the target but did not "
                "persist its state")
        self._final_dir = self._range_dir(final["index"])
        self._gc_range_dirs(keep_index=final["index"])
        total = sum(r["ledgers_replayed"] for r in results)
        self.report = {
            "target": target,
            "workers": self.workers,
            "ranges": results,
            "stitches_verified": stitches,
            "steals": len(self._steal_events),
            "steal_events": self._steal_events,
            "final_ledger_seq": final["final_ledger_seq"],
            "final_hash": final["final_hash"],
            "ledgers_replayed": total,
            "wall_s": round(wall, 3),
            "ledgers_per_s": round(total / wall, 1) if wall > 0 else 0.0,
        }
        if self.mesh_devices:
            self.report["mesh_devices"] = self.mesh_devices
            self.report["device_assignments"] = {
                r["index"]: r.get("device_index") for r in results}
        eventlog.record("History", "INFO", "parallel catchup finished",
                        target=target, stitches=stitches,
                        steals=len(self._steal_events),
                        wall_s=round(wall, 1))
        for r in results:
            log.info("%s", range_summary(r))
        log.info("parallel catchup: %d ledgers over %d ranges in %.1fs "
                 "(%.0f ledgers/s), %d stitches verified, %d steal(s)",
                 total, len(results), wall, self.report["ledgers_per_s"],
                 stitches, len(self._steal_events))
        return self.report

    def _gc_range_dirs(self, keep_index: int) -> None:
        """Interior ranges' state was only ever evidence for the stitch
        proof; reclaim the disk (the dir holding the ledger that reached
        the target survives for adoption)."""
        if self.keep_range_dirs:
            return
        for i in range(self._next_index):
            shutil.rmtree(self._ctl_dir(i), ignore_errors=True)
            if i != keep_index:
                shutil.rmtree(self._range_dir(i), ignore_errors=True)

    # -- adoption ----------------------------------------------------------
    def load_manager(self, bucket_store=None,
                     entry_cache_size: Optional[int] = None,
                     resident_levels: Optional[int] = None):
        """Rebuild a LedgerManager from the last range's persisted state
        (only reachable after run() proved every stitch)."""
        if self.report is None or self._final_dir is None:
            raise CatchupError("parallel catchup has not completed")
        from ..bucket.manager import BucketDir
        from ..database import Database
        from ..ledger.manager import LedgerManager
        db = Database(os.path.join(self._final_dir, "state.db"))
        bdir = BucketDir(os.path.join(self._final_dir, "buckets"))
        return LedgerManager.load_last_known_ledger(
            self.network_id, db, bdir, bucket_store=bucket_store,
            entry_cache_size=entry_cache_size,
            resident_levels=resident_levels)

    def adopt_into(self, database_path: str, bucket_dir_path: str) -> None:
        """Move the verified final range's durable state to the node's
        authoritative paths.  Never called on a failed run — run() raised
        before _final_dir was set, so tampered archives leave the real
        ledger untouched."""
        if self.report is None or self._final_dir is None:
            raise CatchupError("parallel catchup has not completed")
        os.makedirs(os.path.dirname(database_path) or ".", exist_ok=True)
        shutil.move(os.path.join(self._final_dir, "state.db"), database_path)
        if os.path.isdir(bucket_dir_path):
            shutil.rmtree(bucket_dir_path)
        shutil.move(os.path.join(self._final_dir, "buckets"),
                    bucket_dir_path)

    def cleanup(self) -> None:
        """Drop the whole workdir (owned temp dirs only, unless forced)."""
        if self._own_workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)
