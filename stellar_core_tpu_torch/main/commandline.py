"""Command line (reference: src/main/CommandLine.{h,cpp}).

The copy of stellar_core_tpu/main/commandline.py, so far the node
(run, new-db), its catchup subcommands, catchup (single stream, or
--parallel N range workers) and catchup-range (one range worker), and
check-quorum-intersection (on the CPU, as the reference's).  `--accel`
and the config's ACCEL take cuda (the card's kernels), cpu (their plain
versions) or none; the reference's tpu is refused, and so is cuda where
there is no card.  The other subcommands (publish, self-check, ...) are
not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys

from .config import Config

def _load_config(args) -> Config:
    cfg = Config.from_toml(args.conf)
    cfg.apply_process_globals()
    return cfg


def _accel(cfg, what: str):
    """(on, device) of the config's ACCEL, or None after printing why the
    command cannot run: an ACCEL it refuses, or cuda where there is no
    card (checked here, before the command touches anything: there is no
    fallback to the CPU)."""
    try:
        accel, accel_device = cfg.accel()
        if accel:
            from ..catchup.catchup import (PreverifyPipeline,
                                           resolve_accel_devices)
            resolve_accel_devices(accel_device, None,
                                  PreverifyPipeline.DEFAULT_DEVICE)
    except (ValueError, RuntimeError) as e:
        print(f"{what}: {e}", file=sys.stderr)
        return None
    return accel, accel_device


def cmd_new_db(args) -> int:
    """Initialize a fresh database at the config's DATABASE path
    (reference: `stellar-core new-db`)."""
    cfg = _load_config(args)
    if not cfg.DATABASE:
        print("config has no DATABASE path", file=sys.stderr)
        return 1
    if _accel(cfg, "new-db") is None:
        return 1
    import os
    for path in (cfg.DATABASE, cfg.DATABASE + "-wal", cfg.DATABASE + "-shm"):
        if os.path.exists(path):
            os.unlink(path)
    from .application import Application
    app = Application(cfg, listen=False)
    print(f"new database at {cfg.DATABASE}, genesis ledger "
          f"{app.lm.last_closed_ledger_seq} hash {app.lm.lcl_hash.hex()}")
    app.stop()
    return 0


def cmd_run(args) -> int:
    """Run the node (reference: `stellar-core run`)."""
    cfg = _load_config(args)
    if _accel(cfg, "run") is None:
        return 1
    from .application import Application
    app = Application(cfg)
    import signal

    def shutdown(signum, frame):
        app.stop()

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)
    app.start()
    app.run()
    return 0


def _resolve_catchup_target(args):
    """Shared --at/--to resolution for the single-stream and parallel
    catchup routes (one copy, or the two would drift).  Returns
    (error_message, target); exactly one is None."""
    target = None
    if args.at and args.at != "current":
        try:
            target = int(args.at)
        except ValueError:
            return (f"--at must be a ledger number or 'current', "
                    f"got {args.at!r}"), None
    if target is not None and args.to is not None and target != args.to:
        return "--at and --to conflict; give one", None
    return None, (target if target is not None else args.to)


def cmd_catchup(args) -> int:
    """Catch up from a history archive (reference: `stellar-core catchup`);
    `--parallel N` splits the replay into N concurrent checkpoint ranges
    stitched by assume-state (catchup/parallel.py)."""
    cfg = _load_config(args)
    if args.accel:
        cfg.ACCEL = args.accel
    got = _accel(cfg, "catchup")
    if got is None:
        return 1
    accel, accel_device = got
    from ..history.archive import make_archive

    if args.archive:
        archive_spec = args.archive
        archive = make_archive(args.archive)
    elif cfg.HISTORY:
        spec = cfg.HISTORY[0]
        archive_spec = spec.get_path
        archive = make_archive(spec.get_path, spec.put_path, spec.mkdir_cmd)
    else:
        print("no archive configured or given", file=sys.stderr)
        return 1
    workers = args.parallel if args.parallel else cfg.CATCHUP_PARALLEL_WORKERS
    if args.mode == "minimal" or args.count is not None:
        # ranges seed themselves via assume-state already; a minimal or
        # recent-N plan has at most one replay segment to parallelize.
        # Only an EXPLICIT --parallel is an error — config-driven workers
        # (CATCHUP_PARALLEL_WORKERS in node.cfg) must not break commands
        # that were valid before the key was added; they fall back to the
        # single stream.
        if args.parallel > 1:
            print("--parallel applies to complete catchup only (omit "
                  "--mode/--count)", file=sys.stderr)
            return 1
    elif workers > 1:
        return _cmd_catchup_parallel(args, cfg, archive_spec, workers,
                                     accel, accel_device)
    if args.report:
        print("--report applies to --parallel catchup only",
              file=sys.stderr)
        return 1
    from ..catchup.catchup import CatchupManager
    from ..invariant.invariants import InvariantManager
    inv = (InvariantManager.from_patterns(cfg.INVARIANT_CHECKS)
           if cfg.INVARIANT_CHECKS else None)
    store = None
    if not cfg.IN_MEMORY_LEDGER:
        # BucketListDB catchup: assumed/replayed state lives in indexed
        # bucket files instead of an in-memory dict
        import os
        import tempfile
        from ..bucket.manager import BucketListStore
        bdir = cfg.BUCKET_DIR_PATH or (
            os.path.join(os.path.dirname(cfg.DATABASE) or ".", "buckets")
            if cfg.DATABASE else tempfile.mkdtemp(prefix="bucketlistdb-"))
        store = BucketListStore(bdir)
    cm = CatchupManager(cfg.network_id(), cfg.NETWORK_PASSPHRASE,
                        accel=accel, accel_device=accel_device,
                        accel_chunk=cfg.ACCEL_CHUNK_SIZE,
                        invariant_manager=inv,
                        bucket_store=store,
                        entry_cache_size=cfg.BUCKETLISTDB_ENTRY_CACHE_SIZE,
                        resident_levels=cfg.BUCKET_RESIDENT_LEVELS,
                        accel_profile=cfg.ACCEL_OFFLOAD_PROFILE or None)
    err, at = _resolve_catchup_target(args)
    if err:
        print(err, file=sys.stderr)
        return 1
    if args.mode == "minimal":
        if args.count is not None:
            # --count asks for CATCHUP_RECENT (bucket-apply + replay of the
            # last N); an explicit minimal mode would silently drop it
            print("--count conflicts with --mode minimal; omit --mode for "
                  "recent-N catchup", file=sys.stderr)
            return 1
        lm = cm.catchup_minimal(archive, checkpoint=at)
    elif args.count is not None:
        # reference: `catchup --at X --count N` — buckets to the nearest
        # boundary, replay the last N ledgers
        lm = cm.catchup_recent(archive, count=args.count, to_ledger=at)
    else:
        lm = cm.catchup_complete(archive, to_ledger=at)
    print(f"caught up to ledger {lm.last_closed_ledger_seq} "
          f"hash {lm.lcl_hash.hex()}")
    if cfg.DATABASE:
        from ..bucket.manager import BucketDir
        from ..database import Database
        import os
        os.makedirs(os.path.dirname(cfg.DATABASE) or ".", exist_ok=True)
        db = Database(cfg.DATABASE)
        bdir = BucketDir(cfg.BUCKET_DIR_PATH or os.path.join(
            os.path.dirname(cfg.DATABASE) or ".", "buckets"))
        lm.enable_persistence(db, bdir)
        db.close()
        print(f"state persisted to {cfg.DATABASE}")
    return 0


def _cmd_catchup_parallel(args, cfg, archive_spec: str, workers: int,
                          accel: bool, accel_device) -> int:
    """Range-parallel complete catchup: subprocess workers replay N
    contiguous checkpoint ranges, every boundary's stitch is proven, and
    the last range's verified state is adopted as the node's ledger."""
    import os
    from ..catchup.catchup import CatchupError
    from ..catchup.parallel import ParallelCatchup

    err, target = _resolve_catchup_target(args)
    if err:
        print(err, file=sys.stderr)
        return 1
    mesh_devices = (args.mesh_devices if args.mesh_devices >= 0
                    else cfg.CATCHUP_MESH_DEVICES)
    pc = ParallelCatchup(archive_spec, cfg.NETWORK_PASSPHRASE,
                         workers=workers,
                         accel=accel,
                         accel_device=accel_device,
                         accel_chunk=cfg.ACCEL_CHUNK_SIZE,
                         invariant_checks=cfg.INVARIANT_CHECKS,
                         in_memory=cfg.IN_MEMORY_LEDGER,
                         entry_cache_size=cfg.BUCKETLISTDB_ENTRY_CACHE_SIZE,
                         resident_levels=cfg.BUCKET_RESIDENT_LEVELS,
                         steal=(cfg.CATCHUP_WORK_STEALING
                                and not args.no_steal),
                         mesh_devices=mesh_devices,
                         accel_profile=cfg.ACCEL_OFFLOAD_PROFILE or None)
    try:
        report = pc.run(target=target)
    except CatchupError as e:
        print(f"parallel catchup FAILED: {e}", file=sys.stderr)
        pc.cleanup()
        return 1
    print(f"caught up to ledger {report['final_ledger_seq']} "
          f"hash {report['final_hash']} "
          f"({len(report['ranges'])} ranges, "
          f"{report['stitches_verified']} stitches verified, "
          f"{report['ledgers_per_s']} ledgers/s)")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    if cfg.DATABASE:
        bdir = cfg.BUCKET_DIR_PATH or os.path.join(
            os.path.dirname(cfg.DATABASE) or ".", "buckets")
        pc.adopt_into(cfg.DATABASE, bdir)
        print(f"state persisted to {cfg.DATABASE}")
    pc.cleanup()
    return 0


def cmd_catchup_range(args) -> int:
    """One range worker of a parallel catchup (spawned by
    catchup/parallel.py; useful standalone for debugging a range).  Writes
    a JSON stitch record to --result — on failure the record carries an
    "error" key and the exit code is non-zero, so the orchestrator can
    retry with backoff."""
    import os
    from ..catchup.catchup import CatchupError
    from ..catchup.parallel import RangeSpec, run_range
    from ..crypto.sha import sha256
    from ..history.archive import make_archive, set_checkpoint_frequency

    if args.checkpoint_frequency:
        # the orchestrator's cadence is part of the archive format; a
        # worker planning seams at the default 64 against an accelerated
        # fleet's archive would mis-stitch every boundary
        set_checkpoint_frequency(args.checkpoint_frequency)
    archive = make_archive(args.archive)
    seed = (None if args.seed_checkpoint in ("", "genesis")
            else int(args.seed_checkpoint))
    spec = RangeSpec(index=args.index, seed_checkpoint=seed,
                     replay_to=args.to)
    os.makedirs(args.workdir, exist_ok=True)
    native = {"auto": None, "on": True, "off": False}[args.native]
    inv = None
    if args.invariant:
        from ..invariant.invariants import InvariantManager
        inv = InvariantManager.from_patterns(args.invariant)

    def write(doc: dict) -> None:
        tmp = args.result + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, args.result)

    try:
        result = run_range(
            archive, spec, sha256(args.passphrase.encode()),
            args.passphrase,
            accel=args.accel != "none",
            accel_device="cpu" if args.accel == "cpu" else None,
            accel_chunk=args.accel_chunk,
            native=native, invariant_manager=inv,
            bucket_dir=(None if args.in_memory
                        else os.path.join(args.workdir, "bucketlistdb")),
            entry_cache_size=args.entry_cache_size or None,
            resident_levels=(args.resident_levels
                             if args.resident_levels >= 0 else None),
            persist_dir=(args.workdir
                         if args.persist or args.persist_target else None),
            persist_target=args.persist_target or None,
            ctl_dir=args.ctl_dir or None,
            accel_profile=args.accel_profile or None)
    except (CatchupError, RuntimeError, ValueError, OSError) as e:
        write({"index": spec.index, "error": str(e)})
        print(f"range {spec.index} FAILED: {e}", file=sys.stderr)
        return 1
    write(result)
    print(f"range {spec.index}: replayed {result['ledgers_replayed']} "
          f"ledgers to {result['final_ledger_seq']} "
          f"({result['ledgers_per_s']} ledgers/s)")
    return 0


def cmd_check_quorum_intersection(args) -> int:
    """Check quorum intersection of a quorum-map JSON file (reference:
    `stellar-core check-quorum-intersection`)."""
    from ..herder.quorum_intersection import check_intersection
    from ..crypto.keys import PublicKey
    from .. import xdr as X

    with open(args.json_path) as f:
        raw = json.load(f)
    qmap = {}
    for node, spec in raw.items():
        nid = PublicKey.from_strkey(node).ed25519
        qmap[nid] = X.SCPQuorumSet(
            threshold=spec["threshold"],
            validators=[X.NodeID.ed25519(PublicKey.from_strkey(v).ed25519)
                        for v in spec["validators"]],
            innerSets=[])
    res = check_intersection(qmap)
    print("Network enjoys quorum intersection"
          if res.intersects
          else "Network DOES NOT enjoy quorum intersection")
    return 0 if res.intersects else 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="stellar-core-tpu-torch",
        description="stellar-core node with its signature checks on CUDA")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("run", help="run the node")
    s.add_argument("--conf", required=True)
    s.set_defaults(fn=cmd_run)

    s = sub.add_parser("new-db", help="initialize a fresh database")
    s.add_argument("--conf", required=True)
    s.set_defaults(fn=cmd_new_db)

    s = sub.add_parser("catchup", help="catch up from a history archive")
    s.add_argument("--conf", required=True)
    s.add_argument("--archive", default="")
    s.add_argument("--to", type=int, default=None,
                   help="alias of --at as a plain ledger number")
    s.add_argument("--at", default="",
                   help="target ledger, or 'current' for the archive tip")
    s.add_argument("--count", type=int, default=None,
                   help="replay only the last COUNT ledgers; buckets "
                        "cover the rest (CATCHUP_RECENT)")
    s.add_argument("--mode", choices=["complete", "minimal"],
                   default="complete")
    s.add_argument("--parallel", type=int, default=0, metavar="N",
                   help="replay as N concurrent checkpoint ranges stitched "
                        "by assume-state (0 = config "
                        "CATCHUP_PARALLEL_WORKERS)")
    s.add_argument("--mesh-devices", type=int, default=-1, metavar="D",
                   help="pin range workers round-robin to D accelerator "
                        "devices via per-worker visible-device env "
                        "(-1 = config CATCHUP_MESH_DEVICES; 0 = off)")
    s.add_argument("--no-steal", action="store_true",
                   help="disable checkpoint-granular work stealing "
                        "between range workers")
    s.add_argument("--accel", choices=["cuda", "cpu", "none"], default="",
                   help="signature pre-verification: cuda (the card's "
                        "kernels), cpu (their plain versions) or none "
                        "(default: config ACCEL, itself cuda by default)")
    s.add_argument("--report", default="",
                   help="with --parallel: write the run's JSON report "
                        "here, the stitch record of every range included")
    s.set_defaults(fn=cmd_catchup)

    s = sub.add_parser("catchup-range",
                       help="one range worker of a parallel catchup "
                            "(writes a JSON stitch record)")
    s.add_argument("--archive", required=True)
    s.add_argument("--passphrase", required=True)
    s.add_argument("--to", type=int, required=True,
                   help="last ledger of the range")
    s.add_argument("--seed-checkpoint", default="genesis",
                   help="checkpoint boundary to assume-state from, or "
                        "'genesis'")
    s.add_argument("--workdir", required=True,
                   help="range-private dir (BucketListDB store + persisted "
                        "state)")
    s.add_argument("--result", required=True,
                   help="path for the JSON stitch record")
    s.add_argument("--index", type=int, default=0)
    s.add_argument("--persist", action="store_true",
                   help="durably persist the final state into --workdir")
    s.add_argument("--persist-target", type=int, default=0,
                   help="persist only when the replay actually ends at "
                        "this ledger (work stealing: whichever worker "
                        "reaches the catchup target owns the adoptable "
                        "state)")
    s.add_argument("--ctl-dir", default="",
                   help="control dir for progress heartbeats + steal "
                        "limit/ack handshake (survives retry wipes of "
                        "--workdir)")
    s.add_argument("--accel", choices=["cuda", "cpu", "none"],
                   default="none",
                   help="signature pre-verification: cuda (the card's "
                        "kernels), cpu (their plain versions) or none")
    s.add_argument("--accel-chunk", type=int, default=8192)
    s.add_argument("--accel-profile",
                   choices=["poll", "race", "sig-only"], default="",
                   help="preverify offload profile (default: poll — the "
                        "device is never waited on)")
    s.add_argument("--native", choices=["auto", "on", "off"],
                   default="auto")
    s.add_argument("--invariant", action="append", default=[],
                   help="INVARIANT_CHECKS pattern (repeatable); forces "
                        "the Python apply path like the single stream")
    s.add_argument("--in-memory", action="store_true",
                   help="IN_MEMORY_LEDGER mode (no range-private "
                        "BucketListDB store)")
    s.add_argument("--entry-cache-size", type=int, default=0,
                   help="BUCKETLISTDB_ENTRY_CACHE_SIZE (0 = default)")
    s.add_argument("--resident-levels", type=int, default=-1,
                   help="BUCKET_RESIDENT_LEVELS (-1 = default)")
    s.add_argument("--checkpoint-frequency", type=int, default=0,
                   help="checkpoint cadence of the archive's network "
                        "(0 = the default 64)")
    s.set_defaults(fn=cmd_catchup_range)

    s = sub.add_parser("check-quorum-intersection",
                       help="check a quorum map JSON for intersection")
    s.add_argument("json_path")
    s.set_defaults(fn=cmd_check_quorum_intersection)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # stdout piped into a consumer that closed early (| head) — exit
        # quietly like any well-behaved unix tool
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0
