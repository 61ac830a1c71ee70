"""BucketDir: content-addressed on-disk bucket files.

Reference: src/bucket/BucketManager.{h,cpp} — adoptFileAsBucket /
getBucketByHash over `buckets/bucket-<hex>.xdr`, plus forgetUnreferenced
garbage collection.  Files are immutable once written (content-addressed by
SHA-256 of the serialized stream), written atomically via tmp+rename, and
verified against their name hash on load.

``BucketListStore`` layers the BucketListDB authority on top: every saved
file carries a ``DiskBucketIndex`` so point lookups seek into the file,
and live snapshots PIN the files they reference so GC never deletes a
bucket out from under an open read view (reference: BucketManager's
shared-ptr liveness feeding forgetUnreferencedBuckets).
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, Iterable, List, Optional, Set

from ..crypto.sha import SHA256
from ..util import eventlog
from ..util.lockorder import make_rlock
from ..util.metrics import registry as _registry
from ..util.racetrace import race_checked
from .bucket import DEAD_TAG, Bucket, pack_meta
from .index import DiskBucketIndex

_EMPTY_HEX = "0" * 64

# tmp merge outputs need uniqueness, not unpredictability: pid + a
# process-local sequence keeps the name deterministic (rng-discipline)
_MERGE_SEQ = itertools.count()


class BucketDir:
    # every bucket file this directory is supposed to hold, one hex hash
    # per line — written alongside the files so a startup audit can tell
    # "this file was deleted/lost" apart from "this file was never ours".
    # Content addressing alone cannot: a vanished file leaves no trace.
    MANIFEST_NAME = "MANIFEST"

    def __init__(self, path: str):
        self.path = path
        self._manifest_cache: Optional[Set[str]] = None
        os.makedirs(path, exist_ok=True)

    def _file_for(self, hex_hash: str) -> str:
        return os.path.join(self.path, f"bucket-{hex_hash}.xdr")

    # -- manifest ------------------------------------------------------------
    @property
    def _manifest_path(self) -> str:
        return os.path.join(self.path, self.MANIFEST_NAME)

    def _manifest_read(self) -> Set[str]:
        """Well-formed entries only (64 hex chars): a torn tail line from
        a crash mid-append must read as absent — the full-file hash scan
        in audit() still covers whatever file the lost entry named — not
        as a permanently unstartable 'missing bucket <garbage>'.

        Cached in memory after the first read (this instance is the only
        writer for its directory — Application aliases bucket_dir to the
        store): save() membership-checks on every ledger close, and
        re-reading the file each time puts O(manifest) disk reads on the
        persistence hot path.  Only a missing file means 'legacy dir';
        a real I/O error must surface — swallowing EIO here would
        silently disable the missing-bucket half of the startup audit
        exactly when the disk is in trouble."""
        if self._manifest_cache is None:
            try:
                with open(self._manifest_path) as f:
                    self._manifest_cache = {
                        line.strip() for line in f
                        if len(line.strip()) == 64
                        and all(c in "0123456789abcdef"
                                for c in line.strip())}
            except FileNotFoundError:
                self._manifest_cache = set()   # pre-manifest legacy dir
        return set(self._manifest_cache)

    def _manifest_write(self, hashes: Set[str]) -> None:
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            f.write("".join(hh + "\n" for hh in sorted(hashes)))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path)
        self._manifest_cache = set(hashes)

    def _manifest_add(self, hex_hash: str) -> None:
        # O_APPEND one-line write: atomic enough for concurrent adopters;
        # duplicates are harmless (the reader is a set).  If a crash left
        # a torn tail line (no trailing newline), lead with one so this
        # entry does not glue onto the fragment and invalidate both —
        # blank lines are filtered by the reader.
        lead = ""
        try:
            with open(self._manifest_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() > 0:
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) != b"\n":
                        lead = "\n"
        except FileNotFoundError:
            pass
        with open(self._manifest_path, "a") as f:
            f.write(lead + hex_hash + "\n")
        if self._manifest_cache is not None:
            self._manifest_cache.add(hex_hash)

    def _manifest_has(self, hex_hash: str) -> bool:
        # membership against the cache directly — _manifest_read()'s
        # defensive copy is O(manifest) and this runs per ledger close
        if self._manifest_cache is None:
            self._manifest_read()
        return hex_hash in self._manifest_cache

    def _manifest_readopt(self, hex_hash: str) -> None:
        """Re-adopt a file left untracked by a crash between its durable
        rename and the manifest append — otherwise it can never become
        manifest-tracked and its later loss escapes audit()."""
        if not self._manifest_has(hex_hash):
            self._manifest_add(hex_hash)

    def _fsync_dir(self) -> None:
        dfd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def audit(self) -> int:
        """Fail-stop integrity scan, run before on-disk state is trusted
        (reference shape: BucketManager::assumeState verifying buckets
        against the HAS): every manifest-listed bucket file must exist,
        and every bucket file present must hash to its own name — a
        flipped byte or a vanished file raises RuntimeError with the
        offending path instead of surfacing later as wrong ledger state.
        Returns the number of files verified."""
        on_disk: Set[str] = set()
        for name in os.listdir(self.path):
            if name.startswith("bucket-") and name.endswith(".xdr"):
                on_disk.add(name[len("bucket-"):-len(".xdr")])
        for hh in sorted(self._manifest_read()):
            if hh != _EMPTY_HEX and hh not in on_disk:
                raise RuntimeError(f"missing bucket {hh} "
                                   f"(manifest-listed, not on disk)")
        verified = 0
        for hh in sorted(on_disk):
            sha = SHA256()
            with open(self._file_for(hh), "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    sha.add(chunk)
            if sha.finish().hex() != hh:
                raise RuntimeError(
                    f"bucket file {self._file_for(hh)} fails hash check")
            verified += 1
        return verified

    def save(self, bucket: Bucket) -> str:
        """Persist a bucket; returns its hex hash.  Existing files are
        trusted (content addressing makes rewrites pointless)."""
        hh = bucket.hash().hex()
        if bucket.is_empty():
            return _EMPTY_HEX
        target = self._file_for(hh)
        if os.path.exists(target):
            self._manifest_readopt(hh)
            return hh
        tmp = target + ".tmp"
        with open(tmp, "wb") as f:
            f.write(bucket.serialize())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
        # fsync the directory so the rename itself survives power loss —
        # the DB that points at this bucket commits after us
        self._fsync_dir()
        # manifest entry only AFTER the rename is durable: a crash in
        # between leaves an untracked-but-intact file (harmless), never a
        # durable manifest entry whose file rename was lost (a false
        # missing-bucket fail-stop at the next startup audit)
        self._manifest_add(hh)
        return hh

    def load(self, hex_hash: str) -> Optional[Bucket]:
        """Load and hash-verify a bucket; None when absent.  A corrupt file
        raises — silently returning None would let catchup treat corruption
        as absence."""
        if hex_hash == _EMPTY_HEX:
            return Bucket.empty()
        target = self._file_for(hex_hash)
        if not os.path.exists(target):
            return None
        with open(target, "rb") as f:
            bucket = Bucket.deserialize(f.read())
        if bucket.hash().hex() != hex_hash:
            raise RuntimeError(f"bucket file {target} fails hash check")
        return bucket

    def exists(self, hex_hash: str) -> bool:
        return hex_hash == _EMPTY_HEX or os.path.exists(self._file_for(hex_hash))

    def gc(self, referenced: Iterable[str]) -> int:
        """Delete bucket files not in `referenced` (reference:
        BucketManager::forgetUnreferencedBuckets).  Returns removed count.
        The manifest is rewritten BEFORE any unlink: a crash in between
        leaves an untracked-but-intact file (re-collected next pass), never
        a manifest entry whose file is gone (a false missing-bucket
        fail-stop at the next startup audit)."""
        keep: Set[str] = set(referenced)
        keep.update(self._protected_hashes())
        victims: List[str] = []
        for name in os.listdir(self.path):
            if not (name.startswith("bucket-") and name.endswith(".xdr")):
                continue
            hh = name[len("bucket-"):-len(".xdr")]
            if hh not in keep:
                victims.append(hh)
        if victims:
            self._manifest_write(self._manifest_read() - set(victims))
            # the rewrite must be durable BEFORE any unlink: a crash that
            # persists the unlinks but loses the manifest rename would
            # leave durable entries for vanished files — the very false
            # fail-stop this ordering exists to prevent
            self._fsync_dir()
        removed = 0
        for hh in victims:
            os.unlink(self._file_for(hh))
            self._on_removed(hh)
            removed += 1
        return removed

    def _protected_hashes(self) -> Set[str]:
        """Hashes GC must keep beyond the referenced set (BucketListStore
        adds snapshot pins)."""
        return set()

    def _on_removed(self, hex_hash: str) -> None:
        pass


class BucketStreamWriter:
    """Streaming bucket output (reference: BucketOutputIterator): records
    append to a temp file while the content hash and the DiskBucketIndex
    grow incrementally, so a whole merge never holds more than one record
    in memory.  finalize() renames the file to its content address and
    registers the index with the store; content addressing makes a
    collision with an existing file a free dedup.

    Records must arrive in strictly ascending key order — the same
    contract the in-memory merge guarantees — and are NOT inspected
    beyond their leading 4-byte discriminant (the tombstone flag)."""

    __slots__ = ("_store", "_proto", "_tmp", "_f", "_sha", "_off",
                 "_keys", "_offsets", "_dead", "bytes_written")

    def __init__(self, store: "BucketListStore", protocol_version: int):
        self._store = store
        self._proto = protocol_version
        self._tmp = os.path.join(
            store.path,
            f".merge-{os.getpid()}-{next(_MERGE_SEQ)}.tmp")
        self._f = open(self._tmp, "wb", buffering=1 << 16)
        meta = pack_meta(protocol_version)
        self._f.write(meta)
        self._sha = SHA256().add(meta)
        self._off = len(meta)
        self._keys: List[bytes] = []
        self._offsets: List[int] = []
        self._dead = bytearray()
        self.bytes_written = len(meta)

    def write(self, key: bytes, rec: bytes) -> None:
        self._f.write(rec)
        self._sha.add(rec)
        self._keys.append(key)
        self._offsets.append(self._off)
        self._dead.append(1 if rec[:4] == DEAD_TAG else 0)
        self._off += len(rec)
        self.bytes_written += len(rec)

    def finalize(self) -> Bucket:
        """Close + content-address the stream; returns the disk-resident
        Bucket (or a plain empty bucket carrying the output protocol when
        nothing was written — the all-annihilated merge)."""
        if not self._keys:
            self.abort()
            return Bucket([], self._proto)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        self._f = None
        hh = self._sha.finish()
        bucket = self._store._adopt_stream(
            self._tmp, hh, DiskBucketIndex(
                "", self._proto, self._keys, self._offsets, self._off,
                bytes(self._dead)))
        self._tmp = None
        return bucket

    def abort(self) -> None:
        """Discard the stream (merge raised / empty output); idempotent."""
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._tmp is not None:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass
            self._tmp = None


@race_checked
class BucketListStore(BucketDir):
    """BucketDir + per-file ``DiskBucketIndex`` cache + snapshot pinning —
    the storage half of BucketListDB (reference: BucketManager +
    BucketIndexImpl since v21, where the indexed bucket files ARE the
    ledger-entry database and SQL holds no entry tables).

    Indexes are built once per content hash: at save time from the
    in-memory bucket (free — reuses its cached sort keys / packed records)
    or, for files adopted from a previous run, by a hash-verified scan.
    Pins are refcounts held by open ``SearchableBucketListSnapshot``s; GC
    keeps ``referenced ∪ pinned`` so an old snapshot keeps serving a
    consistent view while the live list moves on.
    """

    def __init__(self, path: str):
        super().__init__(path)
        self._indexes: Dict[str, DiskBucketIndex] = {}
        self._pins: Dict[str, int] = {}
        # background streaming merges register outputs from worker threads
        # while the close path reads/pins/GCs on the main thread; reentrant
        # because gc() holds it across the scan and _protected_hashes()
        # re-acquires
        self._lock = make_rlock("bucket.store")
        # weak source: a torn-down store reads as null, never pins the
        # store graph in the process-global registry
        _registry().weak_gauge("bucketlistdb.pin.active", self,
                               BucketListStore.pin_count)

    # -- streaming merge output ----------------------------------------------
    def stream_writer(self, protocol_version: int) -> BucketStreamWriter:
        """Open a streaming bucket output (merge_buckets_raw's sink)."""
        return BucketStreamWriter(self, protocol_version)

    def _adopt_stream(self, tmp_path: str, hash_bytes: bytes,
                      idx: DiskBucketIndex) -> Bucket:
        """Content-address a finished stream file and register its index.
        The output hash is PINNED (released by FutureBucket at commit):
        a background merge can finish between the close path computing
        referenced_hashes and GC unlinking — without the pin that window
        would delete a file the about-to-commit level points at.  Pin,
        register and rename happen under the store lock, and gc() holds
        the same lock across its whole scan, so the file can never become
        visible-but-unpinned mid-collection."""
        hh = hash_bytes.hex()
        target = self._file_for(hh)
        idx.path = target
        with self._lock:
            self._pins[hh] = self._pins.get(hh, 0) + 1
            self._indexes.setdefault(hh, idx)
            idx = self._indexes[hh]
            if os.path.exists(target):
                deduped = True
                os.unlink(tmp_path)  # dedup: identical content already stored
                self._manifest_readopt(hh)
            else:
                deduped = False
                os.replace(tmp_path, target)
                self._fsync_dir()
                # after the rename is durable — same ordering as save()
                self._manifest_add(hh)
        # recorded OUTSIDE the store lock: the event-log lock is a leaf
        eventlog.record("Bucket", "INFO", "stream merge output adopted",
                        hash=hh[:16], entries=len(idx._keys),
                        bytes=idx._file_size, deduped=deduped)
        return Bucket.from_disk(idx, hash_bytes)

    def gc(self, referenced: Iterable[str]) -> int:
        # one atomic scan vs concurrent stream adoptions (see
        # _adopt_stream) — the lock is reentrant for _protected_hashes
        with self._lock:
            removed = super().gc(referenced)
        if removed:
            eventlog.record("Bucket", "INFO", "bucket GC pass",
                            removed=removed)
        return removed

    # -- save + index --------------------------------------------------------
    def ensure(self, bucket: Bucket) -> Optional[DiskBucketIndex]:
        """Persist `bucket` and return its index; None for the empty
        bucket (nothing to look up).  A file this process just wrote is
        indexed for free from the in-memory bucket; a PRE-EXISTING file
        (restart — content addressing trusts names, but the bytes about
        to serve authoritative reads must prove themselves) is adopted
        through the hash-verified scan, so on-disk corruption fail-stops
        here instead of surfacing as wrong ledger state."""
        if bucket.is_empty():
            return None
        attached = bucket.disk_index()
        if attached is not None:
            # a disk-resident bucket (streaming-merge output / prior
            # residency pass) carries its index; adopt it if unseen
            with self._lock:
                return self._indexes.setdefault(bucket.hash().hex(),
                                                attached)
        hh = bucket.hash().hex()
        with self._lock:
            idx = self._indexes.get(hh)
        if idx is not None:
            return idx
        if os.path.exists(self._file_for(hh)):
            self._manifest_readopt(hh)
            return self.index_for(hh)
        self.save(bucket)
        idx = DiskBucketIndex.from_bucket(bucket, self._file_for(hh))
        with self._lock:
            idx = self._indexes.setdefault(hh, idx)
        return idx

    def index_for(self, hex_hash: str) -> Optional[DiskBucketIndex]:
        """Index of an already-on-disk bucket (restart/assume-state path);
        builds via a hash-verified file scan on first use.  None for the
        empty hash; missing files raise (the caller named a bucket the
        store must have)."""
        if hex_hash == _EMPTY_HEX:
            return None
        with self._lock:
            idx = self._indexes.get(hex_hash)
        if idx is None:
            target = self._file_for(hex_hash)
            if not os.path.exists(target):
                raise RuntimeError(f"missing bucket file for {hex_hash}")
            idx = DiskBucketIndex.build(target, expected_hex_hash=hex_hash)
            with self._lock:
                idx = self._indexes.setdefault(hex_hash, idx)
        return idx

    # -- snapshot pinning ----------------------------------------------------
    def pin_count(self) -> int:
        """Distinct bucket files currently pinned (snapshot readers +
        in-flight merge outputs) — the bucketlistdb.pin.active gauge and
        the CloseCostRecord pin column."""
        with self._lock:
            return len(self._pins)

    def pin(self, hex_hashes: Iterable[str]) -> None:
        with self._lock:
            for hh in hex_hashes:
                self._pins[hh] = self._pins.get(hh, 0) + 1

    def unpin(self, hex_hashes: Iterable[str]) -> None:
        with self._lock:
            for hh in hex_hashes:
                n = self._pins.get(hh, 0) - 1
                if n <= 0:
                    self._pins.pop(hh, None)
                else:
                    self._pins[hh] = n

    def _protected_hashes(self) -> Set[str]:
        with self._lock:
            return set(self._pins)

    def _on_removed(self, hex_hash: str) -> None:
        with self._lock:
            self._indexes.pop(hex_hash, None)
