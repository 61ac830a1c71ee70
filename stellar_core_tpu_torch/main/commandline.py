"""Command line (reference: src/main/CommandLine.{h,cpp}).

Subcommands: run / new-db / new-hist / catchup / catchup-range / publish /
check-quorum-intersection / self-check / verify-checkpoints /
report-last-history-checkpoint / offline-info / print-xdr / dump-xdr /
tsdump / dump-ledger / diag-bucket-stats / encode-asset / sign-transaction /
convert-id / http-command / health / fleet / fuzz / gen-fuzz / apply-load /
test / sec-to-pub / gen-seed / version.

The copy of stellar_core_tpu/main/commandline.py.  `--accel` and the
config's ACCEL take cuda (the card's kernels), cpu (their plain versions)
or none; the reference's tpu is refused, and so is cuda where there is no
card.  Every command that builds an Application (run, new-db, new-hist,
publish, self-check, offline-info, diag-bucket-stats, dump-ledger) checks
the config's ACCEL first, as run does: a node's state is never opened by a
command that would then refuse the card.  The fleet's nodes and its
rejoin's range workers take the config's default, STPU_ACCEL where it is
set, else cuda.  check-quorum-intersection runs on the CPU, as the
reference's.
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


def cmd_version(args) -> int:
    from .application import VERSION
    print(VERSION)
    return 0


def cmd_sec_to_pub(args) -> int:
    from ..crypto.keys import SecretKey
    seed = sys.stdin.readline().strip() if args.seed == "-" else args.seed
    print(SecretKey.from_strkey_seed(seed).public_key.to_strkey())
    return 0


def cmd_gen_seed(args) -> int:
    from ..crypto.keys import SecretKey
    sk = SecretKey.random()
    print(json.dumps({"secret": sk.to_strkey_seed(),
                      "public": sk.public_key.to_strkey()}))
    return 0


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
        # only end the crank loop: a teardown run here would run inside
        # whatever the main thread was doing (a close, a merge, a publish)
        # and could wait forever on what that code holds
        app.request_stop()

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)
    app.start()
    try:
        app.run()
    finally:
        app.stop()
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
    from ..catchup.parallel import ParallelCatchup, range_summary

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
    for r in report["ranges"]:
        print(range_summary(r))
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


def cmd_publish(args) -> int:
    """Force-publish the current checkpoint window to the configured
    archives (reference: `stellar-core publish`)."""
    cfg = _load_config(args)
    if _accel(cfg, "publish") is None:
        return 1
    from .application import Application
    app = Application(cfg, listen=False)
    n = app.history.publish_queued_history()
    print(f"published {n} queued checkpoint(s)")
    app.stop()
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


def cmd_new_hist(args) -> int:
    """Initialize the configured history archives with a genesis HAS
    (reference: `stellar-core new-hist`)."""
    cfg = _load_config(args)
    if not cfg.HISTORY:
        print("config has no HISTORY archives", file=sys.stderr)
        return 1
    if _accel(cfg, "new-hist") is None:
        return 1
    from .application import Application
    app = Application(cfg, listen=False)
    for archive in app.history.archives:
        from ..history.archive import HistoryArchiveState
        has = HistoryArchiveState.from_bucket_list(
            app.lm.last_closed_ledger_seq, cfg.NETWORK_PASSPHRASE,
            app.lm.bucket_list)
        archive.put_state(has)
        print("initialized archive at "
              f"{getattr(archive, 'root', '(command transport)')}")
    app.stop()
    return 0


def cmd_self_check(args) -> int:
    """Verify durable state integrity (reference: `stellar-core
    self-check`)."""
    cfg = _load_config(args)
    if _accel(cfg, "self-check") is None:
        return 1
    from .application import Application
    app = Application(cfg, listen=False)
    report = app.self_check()
    print(json.dumps(report, indent=1))
    app.stop()
    return 0 if report["ok"] else 1


def cmd_verify_checkpoints(args) -> int:
    """Verify the header hash chain of an archive (reference:
    `stellar-core verify-checkpoints`)."""
    from ..catchup.catchup import CatchupManager, CatchupError
    from ..history.archive import make_archive
    cfg = _load_config(args) if args.conf else None
    archive = make_archive(args.archive)
    has = archive.get_state()
    if has is None:
        print("archive has no HAS", file=sys.stderr)
        return 1
    nid = cfg.network_id() if cfg else b"\x00" * 32
    cm = CatchupManager(nid, cfg.NETWORK_PASSPHRASE if cfg else "")
    try:
        headers = cm._read_headers(archive, has.current_ledger)
        from ..catchup.catchup import verify_ledger_chain
        verify_ledger_chain(headers)
    except CatchupError as e:
        print(f"verification FAILED: {e}", file=sys.stderr)
        return 1
    print(f"verified {len(headers)} headers through checkpoint "
          f"{has.current_ledger}; tip hash {headers[-1].hash.hex()}")
    return 0


def cmd_report_last_history_checkpoint(args) -> int:
    from ..history.archive import make_archive
    archive = make_archive(args.archive)
    has = archive.get_state()
    if has is None:
        print("archive has no HAS", file=sys.stderr)
        return 1
    print(has.to_json())
    return 0


def cmd_offline_info(args) -> int:
    """Info from durable state without joining the network (reference:
    `stellar-core offline-info`)."""
    cfg = _load_config(args)
    if _accel(cfg, "offline-info") is None:
        return 1
    from .application import Application
    app = Application(cfg, listen=False)
    print(json.dumps({"info": app.info()}, indent=1))
    app.stop()
    return 0


_XDR_TYPES = {
    "tx-envelope": "TransactionEnvelope",
    "tx-result": "TransactionResult",
    "ledger-header": "LedgerHeader",
    "ledger-entry": "LedgerEntry",
    "scp-envelope": "SCPEnvelope",
    "stellar-message": "StellarMessage",
    "bucket-entry": "BucketEntry",
}


def _xdr_to_jsonable(val):
    """Structural dump of any decoded XDR value (reference: XDRCereal
    XDR→JSON printing)."""
    import enum as _enum
    from ..xdr import codec as C
    if isinstance(val, bytes):
        return val.hex()
    if isinstance(val, _enum.IntEnum):
        return val.name
    if isinstance(val, (int, str, bool)) or val is None:
        return val
    if isinstance(val, list):
        return [_xdr_to_jsonable(v) for v in val]
    if hasattr(val, "_spec"):   # struct
        return {f: _xdr_to_jsonable(getattr(val, f))
                for f, _ in val._spec}
    if hasattr(val, "switch"):  # union
        return {"type": _xdr_to_jsonable(val.switch),
                "value": _xdr_to_jsonable(val.value)}
    return repr(val)


def cmd_print_xdr(args) -> int:
    """Decode one XDR value from a file (reference: `stellar-core
    print-xdr`)."""
    from .. import xdr as X
    cls = getattr(X, _XDR_TYPES[args.filetype])
    with open(args.path, "rb") as f:
        data = f.read()
    if args.base64:
        import base64
        data = base64.b64decode(data)
    val = cls.from_xdr(data)
    print(json.dumps(_xdr_to_jsonable(val), indent=1))
    return 0


def cmd_dump_xdr(args) -> int:
    """Decode a stream of length-prefixed XDR records (an archive .xdr
    file) (reference: `stellar-core dump-xdr`)."""
    import gzip
    from .. import xdr as X
    from ..history.archive import unpack_xdr_stream
    cls = getattr(X, _XDR_TYPES[args.filetype])
    adapter = cls._xdr_adapter()
    with open(args.path, "rb") as f:
        data = f.read()
    if args.path.endswith(".gz"):
        data = gzip.decompress(data)
    n = 0
    for rec in unpack_xdr_stream(data):
        val = adapter.unpack(rec)
        print(json.dumps(_xdr_to_jsonable(val)))
        n += 1
    print(f"# {n} records", file=sys.stderr)
    return 0


def cmd_tsdump(args) -> int:
    """Summarize a persisted time-series dump (util/timeseries crash
    artifact): per-series point counts and last values, or the raw
    points of one series with --metric."""
    from ..util.timeseries import load_dump
    try:
        doc = load_dump(args.path)
    except (OSError, ValueError) as exc:
        print(f"tsdump: {exc}", file=sys.stderr)
        return 1
    series = doc["series"]
    if args.metric:
        points = series.get(args.metric)
        if points is None:
            print(f"tsdump: no series {args.metric!r} in dump "
                  f"(has {len(series)})", file=sys.stderr)
            return 1
        for p in points:
            if p["seq"] > args.since:
                print(json.dumps(p))
        return 0
    rows = []
    for name in sorted(series):
        points = [p for p in series[name] if p["seq"] > args.since]
        if not points:
            continue
        last = points[-1]
        rows.append({"metric": name, "points": len(points),
                     "first_seq": points[0]["seq"],
                     "last_seq": last["seq"], "last": last["v"]})
    print(json.dumps({"kind": doc.get("kind"),
                      "reason": doc.get("reason"),
                      "cadence_s": doc.get("cadence_s"),
                      "next_since": doc.get("next_since"),
                      "series": rows}, indent=2))
    return 0


def cmd_diag_bucket_stats(args) -> int:
    """Per-level bucket statistics (reference: `stellar-core
    diag-bucket-stats` — entry counts by type and size per level)."""
    cfg = _load_config(args)
    if _accel(cfg, "diag-bucket-stats") is None:
        return 1
    from .. import xdr as X
    from .application import Application
    app = Application(cfg, listen=False)
    bl = app.lm.bucket_list
    bl.resolve_all_merges()
    out = []
    totals = {"entries": 0, "bytes": 0}
    for i, lvl in enumerate(bl.levels):
        row = {"level": i}
        for attr in ("curr", "snap"):
            b = getattr(lvl, attr)
            by_type: dict = {}
            for be in b.entries:
                if be.switch == X.BucketEntryType.DEADENTRY:
                    name = "DEAD"
                else:
                    name = be.value.data.switch.name
                by_type[name] = by_type.get(name, 0) + 1
            blob = b.serialize()
            row[attr] = {
                "hash": b.hash().hex(),
                "entries": len(b.entries),
                "bytes": len(blob),
                "by_type": by_type,
            }
            totals["entries"] += len(b.entries)
            totals["bytes"] += len(blob)
        out.append(row)
    print(json.dumps({"ledger": app.lm.last_closed_ledger_seq,
                      "levels": out, "totals": totals}, indent=2))
    app.stop()
    return 0


def cmd_dump_ledger(args) -> int:
    """Dump live ledger entries from durable state (reference:
    `stellar-core dump-ledger`)."""
    cfg = _load_config(args)
    if _accel(cfg, "dump-ledger") is None:
        return 1
    from .application import Application
    app = Application(cfg, listen=False)
    snap = app.lm.bucket_list.snapshot(app.lm.last_closed_ledger_seq)
    n = 0
    for entry in snap.scan():
        print(json.dumps(_xdr_to_jsonable(entry)))
        n += 1
        if args.limit and n >= args.limit:
            break
    print(f"# {n} entries at ledger {snap.ledger_seq}", file=sys.stderr)
    app.stop()
    return 0


def cmd_encode_asset(args) -> int:
    """Print the XDR of an asset (reference: `stellar-core encode-asset`)."""
    from .. import xdr as X
    from ..crypto.keys import PublicKey
    if args.code is None:
        asset = X.Asset.native()
    else:
        if not args.issuer:
            print("--issuer is required with --code", file=sys.stderr)
            return 1
        from ..testutils import make_asset
        issuer = X.AccountID.ed25519(
            PublicKey.from_strkey(args.issuer).ed25519)
        asset = make_asset(args.code, issuer)
    print(asset.to_xdr().hex())
    return 0


def cmd_sign_transaction(args) -> int:
    """Add a signature to a transaction-envelope XDR file; the seed comes
    from stdin (reference: `stellar-core sign-transaction`)."""
    from .. import xdr as X
    from ..crypto.keys import SecretKey
    from ..crypto.sha import sha256
    from ..transactions.frame import TransactionFrame
    with open(args.path, "rb") as f:
        env = X.TransactionEnvelope.from_xdr(f.read())
    seed = sys.stdin.readline().strip()
    sk = SecretKey.from_strkey_seed(seed)
    nid = sha256(args.netid.encode())
    frame = TransactionFrame(nid, env)
    env.value.signatures.append(X.DecoratedSignature(
        hint=sk.public_key.hint(),
        signature=sk.sign(frame.content_hash())))
    out = env.to_xdr()
    if args.output:
        with open(args.output, "wb") as f:
            f.write(out)
    else:
        print(out.hex())
    return 0


def cmd_convert_id(args) -> int:
    """Print every representation of a node/account id (reference:
    `stellar-core convert-id`)."""
    from ..crypto.keys import PublicKey
    ident = args.ident
    raw = None
    if ident.startswith("G") and len(ident) == 56:
        raw = PublicKey.from_strkey(ident).ed25519
    else:
        try:
            raw = bytes.fromhex(ident)
        except ValueError:
            pass
    if raw is None or len(raw) != 32:
        print("unrecognized id (want G... strkey or 64 hex chars)",
              file=sys.stderr)
        return 1
    print(json.dumps({
        "hex": raw.hex(),
        "strkey": PublicKey(raw).to_strkey(),
    }, indent=1))
    return 0


def cmd_http_command(args) -> int:
    """Send a command to a running node's admin port (reference:
    `stellar-core http-command`)."""
    import urllib.request
    cfg = _load_config(args)
    cmd = args.cmd if args.cmd.startswith("/") else "/" + args.cmd
    url = f"http://127.0.0.1:{cfg.HTTP_PORT}{cmd}"
    with urllib.request.urlopen(url, timeout=10) as resp:
        print(resp.read().decode())
    return 0


def cmd_health(args) -> int:
    """Probe a running node's /health; exit 0 when ok, 1 when degraded
    or unreachable — the CLI form of the load-balancer probe (wire it
    into systemd watchdogs / container healthchecks).

    ``--retries N --interval S`` turns the one-shot probe into a
    poll-to-readiness loop: up to N re-probes, S seconds apart, exiting 0
    the first time the node answers healthy.  This is how the fleet
    harness (and an operator's deploy script) waits for a booting or
    rejoining node instead of hand-rolling sleep loops."""
    import time as _t
    import urllib.error
    import urllib.request
    cfg = _load_config(args)
    url = f"http://127.0.0.1:{cfg.HTTP_PORT}/health"
    body, code = "", 0
    for attempt in range(args.retries + 1):
        if attempt:
            _t.sleep(args.interval)
        try:
            with urllib.request.urlopen(url, timeout=args.timeout) as resp:
                body = resp.read().decode()
                code = resp.status
        except urllib.error.HTTPError as e:
            body = e.read().decode()
            code = e.code
        except (urllib.error.URLError, OSError) as e:
            body = json.dumps({"status": "unreachable", "detail": str(e)})
            code = 0
        if code == 200:
            break
    print(body)
    return 0 if code == 200 else 1


def cmd_fuzz(args) -> int:
    """Run a deterministic fuzz campaign (reference: `stellar-core fuzz`
    over FuzzerImpl)."""
    from ..fuzz import OverlayFuzzer, TransactionFuzzer, fuzz_xdr_roundtrip
    if args.mode == "tx":
        crashes = TransactionFuzzer(seed=args.seed).run(args.iters)
    elif args.mode == "overlay":
        crashes = OverlayFuzzer(seed=args.seed).run(args.iters)
    else:
        crashes = fuzz_xdr_roundtrip(seed=args.seed, iters=args.iters)
    print(f"{args.mode} fuzz: {args.iters} cases, {len(crashes)} findings")
    for c in crashes[:20]:
        print(f"  {c}")
    return 1 if crashes else 0


def cmd_gen_fuzz(args) -> int:
    """Write a seed corpus of random XDR inputs (reference: `stellar-core
    gen-fuzz`)."""
    import os
    import random as _random
    from .. import xdr as X
    from ..fuzz import random_xdr_value
    os.makedirs(args.output, exist_ok=True)
    rng = _random.Random(args.seed)
    cls = {"tx": X.TransactionEnvelope,
           "overlay": X.StellarMessage}[args.mode]
    n = 0
    for i in range(args.count):
        val = random_xdr_value(cls, rng)
        try:
            blob = val.to_xdr()
        except Exception:  # corelint: disable=exception-hygiene -- unencodable fuzz variants are skipped by design
            continue
        with open(os.path.join(args.output,
                               f"fuzz-{args.mode}-{i:04d}.xdr"), "wb") as f:
            f.write(blob)
        n += 1
    print(f"wrote {n} corpus files to {args.output}")
    return 0


def cmd_apply_load(args) -> int:
    """Max-TPS apply benchmark without consensus (reference:
    `stellar-core apply-load` / ApplyLoad)."""
    from ..simulation.apply_load import ApplyLoad
    al = ApplyLoad(n_accounts=args.accounts)
    report = al.run(n_ledgers=args.ledgers, txs_per_ledger=args.txs)
    print(json.dumps(report, indent=1))
    return 0


def cmd_fleet(args) -> int:
    """Multi-process TCP network soak (simulation/fleet.py): provision N
    real nodes, drive surge-priced traffic through real /tx, execute the
    production-event schedule (kill + `catchup --parallel` rejoin,
    partition + heal, rolling config change) and assert the SLOs.
    Prints the fleet report as one JSON document; exit 0 only when every
    SLO held.  ``--schedule`` takes a JSON event file (see README §Fleet
    soak for the format); without it the standard acceptance script
    runs."""
    import tempfile
    from ..simulation.fleet import (FleetSLOs, run_fleet_soak,
                                    standard_schedule)
    workdir = args.workdir or tempfile.mkdtemp(prefix="fleet-")
    schedule = None
    if args.schedule:
        with open(args.schedule) as f:
            schedule = json.load(f)
        if args.traffic != 25.0:
            # an explicit schedule owns its own `traffic` events
            print("note: --traffic is ignored with --schedule (the "
                  "file's traffic events govern the offered rate)",
                  file=sys.stderr)
    slos = FleetSLOs()
    if args.max_retracking_s is not None:
        slos.max_retracking_s = args.max_retracking_s
    report = run_fleet_soak(
        workdir, n_nodes=args.nodes, schedule=schedule,
        traffic_rate=args.traffic, n_accounts=args.accounts, slos=slos,
        native_close_differential=args.native_differential,
        timeout_s=args.timeout)
    print(json.dumps(report, indent=1))
    return 0 if report["passed"] else 2


def cmd_test(args) -> int:
    """Run the test suite (reference: `stellar-core test` — Catch2 in the
    binary; here it delegates to pytest on the repo's tests/)."""
    import subprocess
    cmd = [sys.executable, "-m", "pytest"] + (args.pytest_args or ["-q"])
    return subprocess.call(cmd)


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

    s = sub.add_parser("publish", help="publish queued checkpoints")
    s.add_argument("--conf", required=True)
    s.set_defaults(fn=cmd_publish)

    s = sub.add_parser("check-quorum-intersection",
                       help="check a quorum map JSON for intersection")
    s.add_argument("json_path")
    s.set_defaults(fn=cmd_check_quorum_intersection)

    s = sub.add_parser("new-hist", help="initialize history archives")
    s.add_argument("--conf", required=True)
    s.set_defaults(fn=cmd_new_hist)

    s = sub.add_parser("self-check", help="verify durable state integrity")
    s.add_argument("--conf", required=True)
    s.set_defaults(fn=cmd_self_check)

    s = sub.add_parser("verify-checkpoints",
                       help="verify an archive's header hash chain")
    s.add_argument("--archive", required=True)
    s.add_argument("--conf", default="")
    s.set_defaults(fn=cmd_verify_checkpoints)

    s = sub.add_parser("report-last-history-checkpoint",
                       help="print an archive's HAS")
    s.add_argument("--archive", required=True)
    s.set_defaults(fn=cmd_report_last_history_checkpoint)

    s = sub.add_parser("offline-info", help="node info from durable state")
    s.add_argument("--conf", required=True)
    s.set_defaults(fn=cmd_offline_info)

    s = sub.add_parser("print-xdr", help="decode one XDR value from a file")
    s.add_argument("path")
    s.add_argument("--filetype", choices=sorted(_XDR_TYPES),
                   default="tx-envelope")
    s.add_argument("--base64", action="store_true")
    s.set_defaults(fn=cmd_print_xdr)

    s = sub.add_parser("dump-xdr", help="decode an XDR stream file")
    s.add_argument("path")
    s.add_argument("--filetype", choices=sorted(_XDR_TYPES),
                   default="ledger-header")
    s.set_defaults(fn=cmd_dump_xdr)

    s = sub.add_parser("tsdump", help="summarize a time-series dump file")
    s.add_argument("path")
    s.add_argument("--metric", default="",
                   help="print the raw points of ONE series")
    s.add_argument("--since", type=int, default=0,
                   help="only points with capture seq > SINCE")
    s.set_defaults(fn=cmd_tsdump)

    s = sub.add_parser("dump-ledger", help="dump live ledger entries")
    s.add_argument("--conf", required=True)
    s.add_argument("--limit", type=int, default=0)
    s.set_defaults(fn=cmd_dump_ledger)

    s = sub.add_parser("diag-bucket-stats",
                       help="per-level bucket entry/size statistics")
    s.add_argument("--conf", required=True)
    s.set_defaults(fn=cmd_diag_bucket_stats)

    s = sub.add_parser("encode-asset", help="print an asset's XDR")
    s.add_argument("--code", default=None)
    s.add_argument("--issuer", default=None)
    s.set_defaults(fn=cmd_encode_asset)

    s = sub.add_parser("sign-transaction",
                       help="sign a tx-envelope XDR file (seed on stdin)")
    s.add_argument("path")
    s.add_argument("--netid", required=True,
                   help="network passphrase")
    s.add_argument("--output", default="")
    s.set_defaults(fn=cmd_sign_transaction)

    s = sub.add_parser("convert-id", help="print id representations")
    s.add_argument("ident")
    s.set_defaults(fn=cmd_convert_id)

    s = sub.add_parser("http-command",
                       help="send a command to a running node")
    s.add_argument("cmd")
    s.add_argument("--conf", required=True)
    s.set_defaults(fn=cmd_http_command)

    s = sub.add_parser("health",
                       help="probe a running node's /health (exit 0=ok)")
    s.add_argument("--conf", required=True)
    s.add_argument("--timeout", type=float, default=5.0)
    s.add_argument("--retries", type=int, default=0,
                   help="re-probe up to N times until healthy (poll a "
                        "booting node to readiness)")
    s.add_argument("--interval", type=float, default=1.0,
                   help="seconds between probes with --retries")
    s.set_defaults(fn=cmd_health)

    s = sub.add_parser("fuzz", help="run a deterministic fuzz campaign")
    s.add_argument("--mode", choices=["tx", "overlay", "xdr"], default="tx")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--iters", type=int, default=500)
    s.set_defaults(fn=cmd_fuzz)

    s = sub.add_parser("gen-fuzz", help="write a fuzz seed corpus")
    s.add_argument("--mode", choices=["tx", "overlay"], default="tx")
    s.add_argument("--output", required=True)
    s.add_argument("--count", type=int, default=100)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_gen_fuzz)

    s = sub.add_parser("apply-load",
                       help="max-TPS apply benchmark (no consensus)")
    s.add_argument("--accounts", type=int, default=1000)
    s.add_argument("--ledgers", type=int, default=20)
    s.add_argument("--txs", type=int, default=200)
    s.set_defaults(fn=cmd_apply_load)

    s = sub.add_parser("fleet",
                       help="multi-process TCP network soak with SLO "
                            "assertions")
    s.add_argument("--nodes", type=int, default=5)
    s.add_argument("--workdir", default="",
                   help="artifact dir (default: fresh temp dir; holds "
                        "per-node logs/configs + fleet-report.json)")
    s.add_argument("--schedule", default="",
                   help="JSON event-schedule file (default: the standard "
                        "kill/rejoin + partition/heal + rolling-config "
                        "script)")
    s.add_argument("--traffic", type=float, default=25.0,
                   help="offered tx/s across the fleet")
    s.add_argument("--accounts", type=int, default=60,
                   help="seed-derived traffic accounts")
    s.add_argument("--timeout", type=float, default=600.0,
                   help="hard wall-clock bound for the schedule")
    s.add_argument("--max-retracking-s", type=float, default=None,
                   help="SLO: kill -> tracking-again budget")
    s.add_argument("--native-differential", type=int, default=8,
                   help="NATIVE_CLOSE_DIFFERENTIAL cadence provisioned "
                        "into every node: each Nth live close is "
                        "spot-checked against the Python oracle "
                        "(0 = off)")
    s.set_defaults(fn=cmd_fleet)

    s = sub.add_parser("test", help="run the test suite (pytest)")
    s.add_argument("pytest_args", nargs="*")
    s.set_defaults(fn=cmd_test)

    s = sub.add_parser("sec-to-pub", help="seed strkey -> public strkey")
    s.add_argument("seed", help="S... seed, or - to read from stdin")
    s.set_defaults(fn=cmd_sec_to_pub)

    s = sub.add_parser("gen-seed", help="generate a random node seed")
    s.set_defaults(fn=cmd_gen_seed)

    s = sub.add_parser("version", help="print version")
    s.set_defaults(fn=cmd_version)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # stdout piped into a consumer that closed early (| head) — exit
        # quietly like any well-behaved unix tool
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0
