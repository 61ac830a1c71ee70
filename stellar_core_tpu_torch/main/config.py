"""Node configuration: TOML file -> Config object.

Reference: src/main/Config.{h,cpp} — the stellar-core.cfg surface.  The
key names mirror the reference's where the concept exists here
(NETWORK_PASSPHRASE, NODE_SEED, NODE_IS_VALIDATOR, QUORUM_SET, KNOWN_PEERS,
PEER_PORT, HTTP_PORT, RUN_STANDALONE, DATABASE, BUCKET_DIR_PATH,
INVARIANT_CHECKS, HISTORY).  Accelerator additions: ACCEL and
ACCEL_CHUNK_SIZE, the `--accel` surface BASELINE.json benchmarks flip.

The copy of stellar_core_tpu/main/config.py; ACCEL takes "cuda" (the
card's kernels, and the default where the reference's is "none": the
port's entry points run on the card unless told otherwise), "cpu" (their
plain versions) or "none" (off).  The reference's "tpu" is refused with
an error: it must not silently mean off here.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

try:
    import tomllib  # stdlib since 3.11
except ModuleNotFoundError:  # 3.10 container: subset parser below
    tomllib = None

from ..crypto.keys import SecretKey
from ..crypto.sha import sha256
from .. import xdr as X


@dataclass
class HistoryArchiveConfig:
    name: str
    get_path: str = ""        # local dir, or command template with {0}/{1}
    put_path: str = ""
    mkdir_cmd: str = ""       # optional remote-mkdir template ({0} = dir)


@dataclass
class Config:
    NETWORK_PASSPHRASE: str = "Standalone TPU Network ; 2026"
    NODE_SEED: Optional[str] = None          # strkey S...
    NODE_IS_VALIDATOR: bool = True
    RUN_STANDALONE: bool = False
    FORCE_SCP: bool = False
    MANUAL_CLOSE: bool = False               # /manualclose trigger allowed

    QUORUM_SET_VALIDATORS: List[str] = field(default_factory=list)  # G...
    QUORUM_SET_THRESHOLD: int = 0            # 0 = simple majority

    PEER_PORT: int = 11625
    HTTP_PORT: int = 0                       # 0 = no admin endpoint
    KNOWN_PEERS: List[str] = field(default_factory=list)  # "host:port"
    TARGET_PEER_CONNECTIONS: int = 8

    DATABASE: str = ""                       # sqlite path; "" = in-memory
    BUCKET_DIR_PATH: str = ""
    # BucketListDB (reference: since v21 the bucket list IS the ledger-entry
    # database).  IN_MEMORY_LEDGER=false routes every ledger-entry read
    # through indexed on-disk bucket files with a bounded LRU entry cache;
    # true keeps the legacy in-memory dict root (tests/sims).
    IN_MEMORY_LEDGER: bool = True
    BUCKETLISTDB_ENTRY_CACHE_SIZE: int = 4096  # LRU entries in LedgerTxnRoot
    # BucketListDB residency depth (phase 2): bucket-list levels >= this
    # hold NO decoded entries — they are served from indexed bucket files
    # and merged by the streaming decode-free path.  Levels below it stay
    # decoded (level 0 merges synchronously inside every close).  Raising
    # it trades memory for fewer file reads; NUM_LEVELS disables eviction.
    BUCKET_RESIDENT_LEVELS: int = 2
    INVARIANT_CHECKS: List[str] = field(default_factory=list)
    HISTORY: List[HistoryArchiveConfig] = field(default_factory=list)

    ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING: bool = False
    METADATA_OUTPUT_STREAM: str = ""         # path for LedgerCloseMeta frames
    # Checkpoint cadence (reference: getCheckpointFrequency — 64 on real
    # networks, 8 under ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING so test
    # fleets publish archives within seconds).  0 = derive from the
    # accelerate flag; any explicit value is part of the archive format
    # and must match across the whole network.
    CHECKPOINT_FREQUENCY: int = 0

    # signature pre-verification: "cuda" (the default; the card's
    # kernels, and an error where there is no card), "cpu" (their plain
    # versions) or "none" (off: libsodium on the CPU).  The environment's
    # STPU_ACCEL, where set, is the default instead (a config file's
    # ACCEL still wins), so a whole machine's nodes and commands can be
    # pointed at the plain versions without editing their configs.
    ACCEL: str = field(default_factory=lambda: os.environ.get(
        "STPU_ACCEL") or "cuda")
    ACCEL_CHUNK_SIZE: int = 8192
    # Preverify offload profile (catchup.PreverifyPipeline): "poll" (the
    # default — collect never waits on the device; a miss degrades to
    # on-demand CPU verification, so the accelerator can only ever ADD
    # throughput), "race" (the legacy bounded wait) or "sig-only" (poll
    # that never self-disables).  "" = the pipeline default.
    ACCEL_OFFLOAD_PROFILE: str = "poll"
    # Native live close (ledger/native_close.py): "auto" routes
    # LedgerManager.close through the C apply engine when the extension
    # is built, the root is in-memory and no invariants are configured;
    # "on" additionally warns loudly when that cannot be honored; "off"
    # keeps the pure-Python close.
    NATIVE_CLOSE: str = "auto"
    # Differential spot-check cadence: every Nth close also runs the
    # Python engine on a scratch copy and fail-stops with a crash bundle
    # on any divergence (results, fees, header hash, bucket hashes).
    # 0 = defer to the NATIVE_CLOSE_DIFFERENTIAL environment variable
    # (unset -> no spot-checks).  N=1 is the differential test tier.
    NATIVE_CLOSE_DIFFERENTIAL: int = 0
    # Range-parallel catchup (catchup/parallel.py): `catchup` splits a
    # complete replay into this many concurrent checkpoint ranges, each a
    # subprocess worker seeding itself via assume-state; every boundary's
    # stitch (final hash == next seed header hash) is proven before the
    # node adopts the last range's state.  1 = classic single stream.
    CATCHUP_PARALLEL_WORKERS: int = 1
    # Device-per-range mesh (catchup/parallel.py + accel/mesh.py): > 0
    # pins each range worker to one accelerator device round-robin via
    # per-worker visible-device env, so N ranges × N devices multiply
    # instead of contending for chip 0.  0 = no pinning.
    CATCHUP_MESH_DEVICES: int = 0
    # Checkpoint-granular work stealing: a finished range worker re-seeds
    # via assume-state at a later boundary and adopts half the slowest
    # range's remaining checkpoints (the stitch proof covers the dynamic
    # seam).  false = static ranges only.
    CATCHUP_WORK_STEALING: bool = True
    # Batched authenticated transport (overlay/peer.py): negotiate
    # AUTH_FLAG_BATCH per link and coalesce batch-eligible sends into
    # one-MAC BATCHED_AUTH frames.  Negotiation falls back to classic
    # per-message frames against peers that don't advertise the flag, so
    # the knob only ever changes this node's own links.  The caps bound
    # one coalescing run (messages / encoded bytes) before a flush.
    OVERLAY_BATCHING: bool = True
    OVERLAY_BATCH_MAX_MESSAGES: int = 64
    OVERLAY_BATCH_MAX_BYTES: int = 131072
    # Batched admission (herder/admission.py): /tx + overlay TRANSACTION
    # intake accumulates into accel-sized verification batches with
    # back-pressure wired to overlay flow control and surge pricing.
    # false = legacy inline single-sig intake.
    ADMISSION: bool = True
    ADMISSION_BATCH_SIZE: int = 256          # flush at this many sigs
    ADMISSION_FLUSH_DELAY_S: float = 0.05    # deadline flush, partial batch
    ADMISSION_MAX_BACKLOG: int = 4096        # then: try-again-later
    LOG_LEVEL: str = "INFO"
    # "json" = one-JSON-object-per-line structured records carrying the
    # current span id (trace correlation); runtime-switchable via
    # /ll?format=.  "text" = the classic human stream.
    LOG_FORMAT: str = "text"
    WORKER_THREADS: int = 4                  # background bucket merges
    # Fleet observability plane.  NODE_NAME stamps every JSON
    # log record, flight-event export and /tracespans document with this
    # node's identity (simulation/fleet provisions "node-N" per node);
    # "" = unattributed single-node run.
    NODE_NAME: str = ""
    # Always-on sampling profiler (util/sampleprof): true starts the
    # ~67 Hz stack sampler at boot ($STPU_SAMPLEPROF=1 overrides to on).
    SAMPLEPROF: bool = False
    # Local SLO burn tracking (util/slo): evaluate the default
    # objectives against this node's own registry every
    # SLO_EVAL_CADENCE_S seconds and serve /slo.  0 = off.
    SLO_EVAL_CADENCE_S: float = 0.0
    SLO_CLOSE_P99_S: float = 2.0             # close-latency objective
    SLO_ADMISSION_P99_S: float = 0.5         # admission-latency objective
    SLO_CATCHUP_RATE: float = 20.0           # ledgers/s replay objective
    SLO_BURN_BUDGET: float = 0.10            # breach fraction allowed
    # Retrospective telemetry.  The in-process time-series
    # store (util/timeseries) snapshots the metric registry every
    # TIMESERIES_CADENCE_S seconds — a VirtualTimer under VIRTUAL_TIME
    # (tests crank it), a wall-cadence daemon on real nodes — and serves
    # /timeseries + tsdump.  0 = off.
    TIMESERIES_CADENCE_S: float = 0.0
    # Adaptive anomaly baselines (util/anomaly): EWMA+MAD regression
    # watch over close p99 / admission latency / merge stall / cache hit
    # rate, evaluated every ANOMALY_EVAL_CADENCE_S seconds.  0 = off.
    ANOMALY_EVAL_CADENCE_S: float = 0.0
    # Soroban execution subsystem.  These override the
    # process-wide SorobanNetworkConfig (soroban/config.py) — resource
    # limits live OFF-ledger here, so enabling them never perturbs
    # genesis or classic ledger hashes.  0 = keep the compiled default.
    SOROBAN_PARALLEL_APPLY: bool = True      # footprint-clustered apply
    SOROBAN_TX_MAX_INSTRUCTIONS: int = 0
    SOROBAN_TX_MAX_MEMORY_BYTES: int = 0
    SOROBAN_LEDGER_MAX_TX_COUNT: int = 0
    SOROBAN_LEDGER_MAX_INSTRUCTIONS: int = 0

    # -- derived -------------------------------------------------------------
    def accel(self):
        """(on, device) of ACCEL for CatchupManager's `accel` and
        `accel_device`: "none" is (False, None), "cuda" (True, None), the
        card, "cpu" (True, "cpu"), the plain versions.  Raises ValueError on
        anything else, the reference's "tpu" included."""
        check_accel(self.ACCEL)
        return self.ACCEL != "none", ("cpu" if self.ACCEL == "cpu" else None)

    def network_id(self) -> bytes:
        return sha256(self.NETWORK_PASSPHRASE.encode())

    def node_secret(self) -> SecretKey:
        if self.NODE_SEED:
            return SecretKey.from_strkey_seed(self.NODE_SEED)
        # deterministic-from-passphrase dev key, like the reference's
        # standalone default
        return SecretKey(sha256(b"node seed " + self.network_id()))

    def checkpoint_frequency(self) -> int:
        """Effective checkpoint cadence (reference:
        HistoryManager::getCheckpointFrequency): an explicit
        CHECKPOINT_FREQUENCY wins, else 8 under the accelerate-time flag,
        else the real-network 64."""
        if self.CHECKPOINT_FREQUENCY:
            return self.CHECKPOINT_FREQUENCY
        return 8 if self.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING else 64

    def apply_process_globals(self) -> None:
        """Install the config's process-wide knobs (today: the checkpoint
        cadence).  Called by the CLI config loader and Application so every
        code path that does checkpoint arithmetic — publishing, catchup,
        maintenance — agrees with the network this config describes."""
        from ..history.archive import set_checkpoint_frequency
        set_checkpoint_frequency(self.checkpoint_frequency())
        overrides = {}
        if self.SOROBAN_TX_MAX_INSTRUCTIONS:
            overrides["tx_max_instructions"] = self.SOROBAN_TX_MAX_INSTRUCTIONS
        if self.SOROBAN_TX_MAX_MEMORY_BYTES:
            overrides["tx_max_memory_bytes"] = self.SOROBAN_TX_MAX_MEMORY_BYTES
        if self.SOROBAN_LEDGER_MAX_TX_COUNT:
            overrides["ledger_max_tx_count"] = self.SOROBAN_LEDGER_MAX_TX_COUNT
        if self.SOROBAN_LEDGER_MAX_INSTRUCTIONS:
            overrides["ledger_max_instructions"] = \
                self.SOROBAN_LEDGER_MAX_INSTRUCTIONS
        if overrides:
            from ..soroban import network_config, set_network_config
            from dataclasses import replace
            set_network_config(replace(network_config(), **overrides))

    def quorum_set(self) -> X.SCPQuorumSet:
        from ..crypto.keys import PublicKey
        validators = [PublicKey.from_strkey(v).ed25519
                      for v in self.QUORUM_SET_VALIDATORS]
        if not validators:
            validators = [self.node_secret().public_key.ed25519]
        threshold = self.QUORUM_SET_THRESHOLD or (len(validators) // 2 + 1)
        return X.SCPQuorumSet(
            threshold=threshold,
            validators=[X.NodeID.ed25519(v) for v in validators],
            innerSets=[])

    @staticmethod
    def from_toml(path: str) -> "Config":
        if tomllib is not None:
            with open(path, "rb") as f:
                raw = tomllib.load(f)
        else:
            # TOML mandates UTF-8; the locale default on a py3.10
            # container is often C/ASCII
            with open(path, "r", encoding="utf-8") as f:
                raw = _parse_toml_subset(f.read())
        return Config.from_dict(raw)

    @staticmethod
    def from_dict(raw: dict) -> "Config":
        cfg = Config()
        simple = {
            "NETWORK_PASSPHRASE", "NODE_SEED", "NODE_IS_VALIDATOR",
            "RUN_STANDALONE", "FORCE_SCP", "MANUAL_CLOSE",
            "PEER_PORT", "HTTP_PORT",
            "KNOWN_PEERS", "TARGET_PEER_CONNECTIONS", "DATABASE",
            "BUCKET_DIR_PATH", "IN_MEMORY_LEDGER",
            "BUCKETLISTDB_ENTRY_CACHE_SIZE", "BUCKET_RESIDENT_LEVELS",
            "INVARIANT_CHECKS", "ACCEL",
            "ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING",
            "METADATA_OUTPUT_STREAM",
            "ACCEL_CHUNK_SIZE", "ACCEL_OFFLOAD_PROFILE",
            "CATCHUP_PARALLEL_WORKERS", "CATCHUP_MESH_DEVICES",
            "CATCHUP_WORK_STEALING",
            "CHECKPOINT_FREQUENCY",
            "NATIVE_CLOSE", "NATIVE_CLOSE_DIFFERENTIAL",
            "LOG_LEVEL", "LOG_FORMAT", "WORKER_THREADS",
            "ADMISSION", "ADMISSION_BATCH_SIZE", "ADMISSION_FLUSH_DELAY_S",
            "ADMISSION_MAX_BACKLOG",
            "OVERLAY_BATCHING", "OVERLAY_BATCH_MAX_MESSAGES",
            "OVERLAY_BATCH_MAX_BYTES",
            "NODE_NAME", "SAMPLEPROF", "SLO_EVAL_CADENCE_S",
            "SLO_CLOSE_P99_S", "SLO_ADMISSION_P99_S", "SLO_CATCHUP_RATE",
            "SLO_BURN_BUDGET",
            "TIMESERIES_CADENCE_S", "ANOMALY_EVAL_CADENCE_S",
            "SOROBAN_PARALLEL_APPLY", "SOROBAN_TX_MAX_INSTRUCTIONS",
            "SOROBAN_TX_MAX_MEMORY_BYTES", "SOROBAN_LEDGER_MAX_TX_COUNT",
            "SOROBAN_LEDGER_MAX_INSTRUCTIONS",
        }
        for key, val in raw.items():
            if key == "ACCEL":
                check_accel(val)
            if key in simple:
                setattr(cfg, key, val)
            elif key == "QUORUM_SET":
                cfg.QUORUM_SET_VALIDATORS = list(val.get("VALIDATORS", []))
                cfg.QUORUM_SET_THRESHOLD = int(val.get("THRESHOLD", 0))
            elif key == "HISTORY":
                for name, spec in val.items():
                    cfg.HISTORY.append(HistoryArchiveConfig(
                        name=name, get_path=spec.get("get", ""),
                        put_path=spec.get("put", ""),
                        mkdir_cmd=spec.get("mkdir", "")))
            # unknown keys are tolerated (reference warns; we ignore)
        return cfg


ACCEL_CHOICES = ("none", "cuda", "cpu")


def check_accel(value) -> None:
    """Raise ValueError unless `value` is one of ACCEL_CHOICES."""
    if value not in ACCEL_CHOICES:
        hint = (" (the JAX package's TPU offload; this package runs on "
                "CUDA: use \"cuda\")" if value == "tpu" else "")
        raise ValueError(f"ACCEL = {value!r} is not one of "
                         f"{', '.join(ACCEL_CHOICES)}{hint}")


def _parse_toml_subset(text: str) -> dict:
    """Minimal TOML-subset parser for Python < 3.11 (no stdlib tomllib):
    `[dotted.section]` tables plus `KEY = value` pairs whose values are
    JSON-compatible TOML (basic strings, integers, floats, booleans,
    single-line arrays) — exactly the node.cfg surface this repo's docs
    and tests use."""
    def strip_comment(line: str) -> str:
        # an unquoted '#' starts a comment; '#' inside a basic string
        # does not (the subset's strings are JSON-style double-quoted).
        # Escape state is tracked, not peeked: a string ending in an
        # escaped backslash ("x\\") must still close on its quote.
        in_str = escaped = False
        for i, c in enumerate(line):
            if in_str:
                if escaped:
                    escaped = False
                elif c == "\\":
                    escaped = True
                elif c == '"':
                    in_str = False
            elif c == '"':
                in_str = True
            elif c == "#":
                return line[:i]
        return line

    root: dict = {}
    table = root
    for lineno, raw_line in enumerate(text.splitlines(), 1):
        line = strip_comment(raw_line).strip()
        if not line:
            continue
        if line.startswith("[") and line.endswith("]"):
            table = root
            for part in line[1:-1].strip().split("."):
                nxt = table.setdefault(part.strip(), {})
                if not isinstance(nxt, dict):
                    raise ValueError(
                        f"config line {lineno}: section {line} collides "
                        f"with key {part.strip()!r}")
                table = nxt
            continue
        key, sep, val = line.partition("=")
        if not sep:
            raise ValueError(f"config line {lineno}: expected KEY = value")
        try:
            table[key.strip()] = json.loads(val.strip())
        except ValueError as e:
            raise ValueError(
                f"config line {lineno}: unsupported TOML value "
                f"{val.strip()!r} (full TOML needs Python 3.11+)") from e
    return root
