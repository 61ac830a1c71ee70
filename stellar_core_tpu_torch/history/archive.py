"""History archives: the checkpoint file store.

Reference: src/history/HistoryArchive.{h,cpp} (HistoryArchiveState — the
`.well-known/stellar-history.json` HAS document), FileTransferInfo.h (path
scheme `category/ww/xx/yy/category-<hex8>.xdr.gz`), and the XDR file stream
record framing from xdrpp (util/XDRStream.h — XDRInputFileStream): each
record is a 4-byte big-endian header whose MSB marks the final fragment and
low 31 bits carry the length, followed by the XDR body.

Archives are dumb file stores; the reference drives them with configured
get/put shell commands (cp/curl).  Here an archive is a directory with the
same layout, and the command indirection arrives with ProcessManager.
"""

from __future__ import annotations

import gzip
import json
import os
import re
import struct
from typing import Iterator, List, Optional

from .. import xdr as X
from ..bucket.bucket import Bucket

CHECKPOINT_FREQUENCY = 64
HAS_CURRENT_VERSION = 1


def checkpoint_frequency() -> int:
    """The process-wide checkpoint cadence.  64 on real networks; test
    fleets shrink it (reference: HistoryManager::getCheckpointFrequency
    returns 8 under ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING) so archives
    publish — and rejoining nodes can catch up — within seconds.  Callers
    that do checkpoint arithmetic must read it through this accessor (or
    the helpers below), never bind the constant at import time."""
    return CHECKPOINT_FREQUENCY


def set_checkpoint_frequency(n: int) -> None:
    """Set the process-wide checkpoint cadence.  Every node of a network
    and every catchup worker replaying its archives must agree on this
    number — it is part of the archive format, which is why it travels in
    node configs (Config.CHECKPOINT_FREQUENCY) and in the catchup-range
    worker command line rather than being flipped ad hoc."""
    global CHECKPOINT_FREQUENCY
    if n < 2:
        raise ValueError(f"checkpoint frequency must be >= 2, got {n}")
    CHECKPOINT_FREQUENCY = n

CATEGORY_LEDGER = "ledger"
CATEGORY_TRANSACTIONS = "transactions"
CATEGORY_RESULTS = "results"
CATEGORY_SCP = "scp"
CATEGORY_BUCKET = "bucket"


def is_checkpoint_boundary(ledger_seq: int) -> bool:
    """Checkpoints close at seq ≡ 63 (mod 64) (reference:
    HistoryManager::isLastLedgerInCheckpoint; first checkpoint is 1..63)."""
    return (ledger_seq + 1) % CHECKPOINT_FREQUENCY == 0


def checkpoint_containing(ledger_seq: int) -> int:
    """The checkpoint ledger (its last seq) that contains ledger_seq."""
    return ((ledger_seq // CHECKPOINT_FREQUENCY) + 1) * CHECKPOINT_FREQUENCY - 1


def first_ledger_in_checkpoint(checkpoint: int) -> int:
    return max(1, checkpoint + 1 - CHECKPOINT_FREQUENCY)


# -- XDR record-mark stream framing (xdrpp compatible) ----------------------

def pack_xdr_stream(records: List[bytes]) -> bytes:
    out = bytearray()
    for rec in records:
        out += struct.pack(">I", len(rec) | 0x80000000)
        out += rec
    return bytes(out)


def unpack_xdr_stream(data: bytes) -> Iterator[bytes]:
    off = 0
    while off < len(data):
        if off + 4 > len(data):
            raise ValueError("truncated record mark")
        (mark,) = struct.unpack_from(">I", data, off)
        length = mark & 0x7FFFFFFF
        off += 4
        if off + length > len(data):
            raise ValueError("truncated record body")
        yield data[off:off + length]
        off += length


# -- path scheme ------------------------------------------------------------

def _hex8(n: int) -> str:
    return f"{n:08x}"


def category_path(category: str, checkpoint: int, suffix: str = ".xdr.gz") -> str:
    h = _hex8(checkpoint)
    return f"{category}/{h[0:2]}/{h[2:4]}/{h[4:6]}/{category}-{h}{suffix}"


_HEX256_RE = re.compile(r"[0-9a-f]{64}")


def require_hex256(hash_hex: str) -> str:
    """Strict SHA-256 hex validation (reference: hexToBin256).  HAS files
    come from untrusted archives and their hashes are interpolated into
    filesystem paths and shell command templates — anything that is not
    exactly 64 lowercase hex chars is rejected before it gets near either.
    """
    if not isinstance(hash_hex, str) or _HEX256_RE.fullmatch(hash_hex) is None:
        raise ValueError(f"invalid bucket hash in archive data: {hash_hex!r}")
    return hash_hex


def bucket_path(hash_hex: str) -> str:
    require_hex256(hash_hex)
    return (f"bucket/{hash_hex[0:2]}/{hash_hex[2:4]}/{hash_hex[4:6]}/"
            f"bucket-{hash_hex}.xdr.gz")


# -- HistoryArchiveState ----------------------------------------------------

class HistoryArchiveState:
    """The HAS JSON: current ledger + the bucket hash list per level."""

    def __init__(self, current_ledger: int, network_passphrase: str,
                 level_hashes: List[dict], server: str = "stellar-core-tpu"):
        self.version = HAS_CURRENT_VERSION
        self.server = server
        self.current_ledger = current_ledger
        self.network_passphrase = network_passphrase
        # [{"curr": hex, "snap": hex, "next": <dict|None>}, ...] — "next" is
        # the level's pending merge (reference: FutureBucket::save):
        # {"state": 1, "output": hex} once resolved (FB_HASH_OUTPUT) or
        # {"state": 2, "curr": hex, "snap": hex, keepTombstones,
        # outputProtocol} while running (FB_HASH_INPUTS).  Restart/catchup
        # must restore it to reproduce later bucket hashes.
        self.level_hashes = level_hashes

    @staticmethod
    def from_bucket_list(current_ledger: int, network_passphrase: str,
                         bucket_list,
                         resolve: bool = True) -> "HistoryArchiveState":
        """Snapshot a live bucket list.  resolve=True (publish path) blocks
        until merges finish — the reference requires resolved futures in
        published HAS files; resolve=False (per-close durable HAS) never
        blocks and serializes running merges as inputs."""
        if resolve:
            bucket_list.resolve_all_merges()
        level_hashes = [
            {"curr": lvl.curr.hash().hex(), "snap": lvl.snap.hash().hex(),
             "next": (lvl.next.serialize() if lvl.next is not None
                      else None)}
            for lvl in bucket_list.levels]
        return HistoryArchiveState(current_ledger, network_passphrase,
                                   level_hashes)

    def to_json(self) -> str:
        return json.dumps({
            "version": self.version,
            "server": self.server,
            "currentLedger": self.current_ledger,
            "networkPassphrase": self.network_passphrase,
            "currentBuckets": [
                {"curr": lh["curr"], "snap": lh["snap"],
                 "next": lh.get("next") or {"state": 0}}
                for lh in self.level_hashes],
        }, indent=2)

    @staticmethod
    def from_json(text: str) -> "HistoryArchiveState":
        """Parse an UNTRUSTED archive's HAS; every malformation (bad json,
        missing keys, wrong types, invalid hashes) raises ValueError so
        callers fail-stop with one localized error class."""
        try:
            d = json.loads(text)
            levels = []
            for b in d["currentBuckets"]:
                nxt = b.get("next")
                if nxt is not None and nxt.get("state", 0) == 0:
                    nxt = None
                if nxt is not None:
                    for key in ("output", "curr", "snap"):
                        if key in nxt and nxt[key] is not None:
                            require_hex256(nxt[key])
                levels.append({"curr": require_hex256(b["curr"]),
                               "snap": require_hex256(b["snap"]),
                               "next": nxt})
            return HistoryArchiveState(
                current_ledger=int(d["currentLedger"]),
                network_passphrase=d.get("networkPassphrase", ""),
                level_hashes=levels,
                server=d.get("server", ""))
        except (KeyError, TypeError, AttributeError) as e:
            raise ValueError(f"malformed HAS json: {e!r}") from e

    def bucket_hashes(self) -> List[str]:
        """curr/snap hashes, 2 per level (positional: level*2 + {0,1})."""
        out = []
        for lh in self.level_hashes:
            out.append(lh["curr"])
            out.append(lh["snap"])
        return out

    def next_states(self) -> List[Optional[dict]]:
        """Per-level pending-merge record, or None when clear."""
        return [lh.get("next") for lh in self.level_hashes]

    def rehydrate_next(self, level: int, bucket_source):
        """Rebuild a level's FutureBucket from its serialized form
        (reference: FutureBucket::makeLive).  bucket_source(hex) -> Bucket
        must raise or return None for missing buckets; the all-zero hash is
        the (perfectly valid) empty bucket."""
        from ..bucket.bucket import Bucket
        from ..bucket.future import FutureBucket

        nxt = self.level_hashes[level].get("next")
        if nxt is None:
            return None

        def load(hh: str) -> Bucket:
            if hh == "0" * 64:
                return Bucket.empty()
            try:
                b = bucket_source(hh)
            except (ValueError, OSError) as e:   # hash mismatch / hostile
                raise RuntimeError(str(e)) from e   # gzip / file IO fault
            if b is None:
                raise RuntimeError(f"missing bucket {hh}")
            return b

        # the HAS comes from an untrusted archive: a `next` record that
        # lies about its own shape (unknown state, missing/garbage fields)
        # must fail-stop as a localized archive error, not a KeyError
        try:
            state = int(nxt["state"])
            if state == 1:
                spec = ("output",)
            elif state == 2:
                spec = ("curr", "snap", "keepTombstones", "outputProtocol")
            else:
                raise RuntimeError(
                    f"HAS level {level} next has invalid state {state}")
            fields = {k: nxt[k] for k in spec}
            for k in spec:
                if k in ("output", "curr", "snap"):
                    require_hex256(fields[k])
            if state == 2:
                fields["outputProtocol"] = int(fields["outputProtocol"])
        except (KeyError, TypeError, ValueError) as e:
            raise RuntimeError(
                f"HAS level {level} next record malformed: {e!r}") from e
        if state == 1:
            return FutureBucket.from_output(load(fields["output"]))
        # state 2: re-run the merge from inputs (synchronously — restart
        # is not the hot path)
        return FutureBucket(load(fields["curr"]), load(fields["snap"]),
                            bool(fields["keepTombstones"]),
                            fields["outputProtocol"])

    def all_bucket_hashes(self) -> List[str]:
        """Every referenced bucket incl. next outputs/inputs (what catchup
        must download and what GC must keep — reference:
        HistoryArchiveState::differingBuckets scope)."""
        out = self.bucket_hashes()
        for nxt in self.next_states():
            if nxt is None:
                continue
            if nxt["state"] == 1:
                out.append(nxt["output"])
            else:
                out.extend((nxt["curr"], nxt["snap"]))
        return out


# -- archives ---------------------------------------------------------------

class HistoryArchiveBase:
    """Category/HAS/bucket layer shared by every archive transport; the
    transport provides get_bytes/put_bytes/exists (reference: the archive
    itself is a dumb blob store — HistoryArchive only knows paths)."""

    WELL_KNOWN = ".well-known/stellar-history.json"

    def put_bytes(self, rel: str, data: bytes) -> None:
        raise NotImplementedError

    def get_bytes(self, rel: str) -> Optional[bytes]:
        raise NotImplementedError

    def exists(self, rel: str) -> bool:
        return self.get_bytes(rel) is not None

    # Memory bound for one decompressed history object (checkpoint files
    # are a few MB in practice; a hostile archive can serve a tiny .gz
    # that inflates without limit — decompression is CAPPED so parsing
    # stays memory-bound, reference fail-stop discipline SURVEY §5.3)
    MAX_DECOMPRESSED_BYTES = 256 * 1024 * 1024

    @classmethod
    def _bounded_gunzip(cls, raw: bytes, what: str) -> bytes:
        import zlib
        try:
            d = zlib.decompressobj(wbits=31)   # gzip container
            out = d.decompress(raw, cls.MAX_DECOMPRESSED_BYTES)
            if d.unconsumed_tail:
                raise ValueError(
                    f"{what} inflates past the "
                    f"{cls.MAX_DECOMPRESSED_BYTES}-byte cap")
            out += d.flush()
            if len(out) > cls.MAX_DECOMPRESSED_BYTES:
                raise ValueError(
                    f"{what} inflates past the "
                    f"{cls.MAX_DECOMPRESSED_BYTES}-byte cap")
            if not d.eof:
                # a stream cut at a deflate-block boundary decompresses
                # without error but never reaches the gzip trailer (CRC) —
                # gzip.decompress rejected this and so must we
                raise ValueError(f"{what} is a truncated gzip stream")
            if d.unused_data:
                raise ValueError(f"{what} has trailing data after the "
                                 "gzip stream")
            return out
        except zlib.error as e:
            raise ValueError(f"{what} is not valid gzip data: {e}") from e

    # gzip'd XDR streams
    def put_xdr_file(self, rel: str, records: List[bytes]) -> None:
        self.put_bytes(rel, gzip.compress(pack_xdr_stream(records)))

    def get_xdr_file(self, rel: str) -> Optional[List[bytes]]:
        raw = self.get_bytes(rel)
        if raw is None:
            return None
        return list(unpack_xdr_stream(self._bounded_gunzip(raw, rel)))

    # HAS
    def put_state(self, has: HistoryArchiveState) -> None:
        data = has.to_json().encode()
        self.put_bytes(self.WELL_KNOWN, data)
        self.put_bytes(category_path("history", has.current_ledger,
                                     suffix=".json"), data)

    def get_state(self, checkpoint: Optional[int] = None
                  ) -> Optional[HistoryArchiveState]:
        if checkpoint is None:
            raw = self.get_bytes(self.WELL_KNOWN)
        else:
            raw = self.get_bytes(category_path("history", checkpoint,
                                               suffix=".json"))
        return HistoryArchiveState.from_json(raw.decode()) if raw else None

    # buckets
    def put_bucket(self, bucket: Bucket) -> None:
        if bucket.is_empty():
            return
        self.put_bytes(bucket_path(bucket.hash().hex()),
                       gzip.compress(bucket.serialize()))

    def get_bucket(self, hash_hex: str) -> Optional[Bucket]:
        raw = self.get_bytes(bucket_path(hash_hex))
        if raw is None:
            return None
        b = Bucket.deserialize(
            self._bounded_gunzip(raw, f"bucket {hash_hex}"))
        if b.hash().hex() != hash_hex:
            raise ValueError(f"bucket hash mismatch for {hash_hex}")
        return b


class FileHistoryArchive(HistoryArchiveBase):
    """Local directory archive (the TmpDirHistoryConfigurator analog used by
    every reference history test — SURVEY.md §4 fixtures)."""

    def __init__(self, root: str):
        self.root = root

    def _full(self, rel: str) -> str:
        return os.path.join(self.root, rel)

    # a .tmp.<pid> this old is litter from a publisher that died
    # mid-write (fleet kills do this by design).  The window is an hour:
    # generous enough that even a pathologically descheduled live writer
    # has long since replaced its tmp, and the retry below makes an
    # over-eager reap a rewrite, never a crash.
    STALE_TMP_S = 3600.0

    def put_bytes(self, rel: str, data: bytes) -> None:
        path = self._full(rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # per-process tmp name: two node processes publishing the same
        # object (a shared fleet archive) must not interleave writes into
        # one tmp file — each writes its own and the os.replace is atomic,
        # so readers only ever see a complete object
        tmp = f"{path}.tmp.{os.getpid()}"
        for attempt in range(2):
            with open(tmp, "wb") as f:
                f.write(data)
            try:
                os.replace(tmp, path)
                break
            except FileNotFoundError:
                # another publisher's reaper mistook our tmp for litter
                # (clock skew / extreme descheduling): rewrite once
                if attempt:
                    raise
        # self-heal: a publisher SIGKILLed between open and replace left
        # its tmp behind; reap aged ones so a long-lived shared archive
        # doesn't accumulate torn litter across soaks
        import glob
        from ..util.clock import wall_now
        for stale in glob.glob(path + ".tmp.*"):
            if stale == tmp:
                continue
            try:
                if wall_now() - os.path.getmtime(stale) > self.STALE_TMP_S:
                    os.unlink(stale)
            except OSError:
                pass

    def get_bytes(self, rel: str) -> Optional[bytes]:
        try:
            with open(self._full(rel), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def exists(self, rel: str) -> bool:
        return os.path.exists(self._full(rel))


class CommandHistoryArchive(HistoryArchiveBase):
    """Shell-command archive transport (reference: HistoryArchive
    get=/put=/mkdir= templates in [HISTORY.<name>], run as subprocesses —
    `curl -sf {0} -o {1}`, `aws s3 cp {0} {1}`, `cp {0} {1}` ...).

    Templates use `{0}`/`{1}` exactly like the reference: for *get*,
    {0} = remote path, {1} = local destination file; for *put*,
    {0} = local source file, {1} = remote path.  Commands run
    synchronously here; the historywork units add pipelining above this
    layer (reference: ProcessManager runs N gets concurrently — the Work
    DAG achieves the overlap in this framework)."""

    def __init__(self, get_template: str = "", put_template: str = "",
                 mkdir_template: str = ""):
        import tempfile
        self.get_template = get_template
        self.put_template = put_template
        self.mkdir_template = mkdir_template
        self._tmp = tempfile.mkdtemp(prefix="sctpu-archive-")
        self._made_dirs: set = set()

    @staticmethod
    def _q(path: str) -> str:
        # Paths reaching the shell are archive-derived (category_path /
        # bucket_path, both strictly validated) — quoting is defense in
        # depth against any future caller passing raw remote data.
        import shlex
        return shlex.quote(path)

    def _run(self, cmdline: str) -> bool:
        import subprocess
        from ..util import logging as slog
        res = subprocess.run(cmdline, shell=True, capture_output=True)
        if res.returncode != 0:
            slog.get("History").warning(
                "archive command failed (%d): %s", res.returncode, cmdline)
        return res.returncode == 0

    def _mkdir_remote(self, rel: str) -> None:
        if not self.mkdir_template:
            return
        d = os.path.dirname(rel)
        if d and d not in self._made_dirs:
            # cache only on success — a transient mkdir failure must be
            # retried by the next put, not poisoned into the cache
            if self._run(self.mkdir_template.format(self._q(d))):
                self._made_dirs.add(d)

    def put_bytes(self, rel: str, data: bytes) -> None:
        if not self.put_template:
            raise RuntimeError("archive has no put command")
        local = os.path.join(self._tmp, "put.tmp")
        with open(local, "wb") as f:
            f.write(data)
        self._mkdir_remote(rel)
        if not self._run(self.put_template.format(self._q(local), self._q(rel))):
            raise RuntimeError(f"archive put failed for {rel}")

    def get_bytes(self, rel: str) -> Optional[bytes]:
        if not self.get_template:
            raise RuntimeError("archive has no get command")
        local = os.path.join(self._tmp, "get.tmp")
        try:
            os.unlink(local)
        except FileNotFoundError:
            pass
        if not self._run(self.get_template.format(self._q(rel), self._q(local))):
            return None
        try:
            with open(local, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None


def make_archive(get_spec: str = "", put_spec: str = "",
                 mkdir_spec: str = ""):
    """Config → archive: specs containing `{0}` are command templates
    (reference semantics); a bare path is a local directory archive."""
    if "{0}" in get_spec or "{0}" in put_spec:
        return CommandHistoryArchive(get_template=get_spec,
                                     put_template=put_spec,
                                     mkdir_template=mkdir_spec)
    return FileHistoryArchive(put_spec or get_spec)
