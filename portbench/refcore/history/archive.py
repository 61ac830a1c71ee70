"""History archives: the checkpoint file store, as a publisher writes it.

Reference: src/history/HistoryArchive.{h,cpp} (HistoryArchiveState — the
`.well-known/stellar-history.json` HAS document), FileTransferInfo.h (path
scheme `category/ww/xx/yy/category-<hex8>.xdr.gz`), and the XDR file stream
record framing from xdrpp (util/XDRStream.h): each record is a 4-byte
big-endian header whose MSB marks the final fragment and low 31 bits carry
the length, followed by the XDR body.  An archive here is a directory with
the same layout.
"""

from __future__ import annotations

import gzip
import json
import os
import struct
from typing import List

from ..bucket.bucket import Bucket

CHECKPOINT_FREQUENCY = 64
HAS_CURRENT_VERSION = 1

CATEGORY_LEDGER = "ledger"
CATEGORY_TRANSACTIONS = "transactions"
CATEGORY_RESULTS = "results"


def is_checkpoint_boundary(ledger_seq: int) -> bool:
    """Checkpoints close at seq ≡ 63 (mod 64) (reference:
    HistoryManager::isLastLedgerInCheckpoint; first checkpoint is 1..63)."""
    return (ledger_seq + 1) % CHECKPOINT_FREQUENCY == 0


def pack_xdr_stream(records: List[bytes]) -> bytes:
    out = bytearray()
    for rec in records:
        out += struct.pack(">I", len(rec) | 0x80000000)
        out += rec
    return bytes(out)


def category_path(category: str, checkpoint: int,
                  suffix: str = ".xdr.gz") -> str:
    h = f"{checkpoint:08x}"
    return f"{category}/{h[0:2]}/{h[2:4]}/{h[4:6]}/{category}-{h}{suffix}"


def bucket_path(hash_hex: str) -> str:
    return (f"bucket/{hash_hex[0:2]}/{hash_hex[2:4]}/{hash_hex[4:6]}/"
            f"bucket-{hash_hex}.xdr.gz")


class HistoryArchiveState:
    """The HAS JSON: current ledger + the bucket hash list per level, each
    level's pending merge as its resolved output (reference:
    FutureBucket::save, FB_HASH_OUTPUT)."""

    def __init__(self, current_ledger: int, network_passphrase: str,
                 level_hashes: List[dict], server: str = "stellar-core-tpu"):
        self.version = HAS_CURRENT_VERSION
        self.server = server
        self.current_ledger = current_ledger
        self.network_passphrase = network_passphrase
        self.level_hashes = level_hashes

    @staticmethod
    def from_bucket_list(current_ledger: int, network_passphrase: str,
                         bucket_list) -> "HistoryArchiveState":
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


class FileHistoryArchive:
    """A local directory archive."""

    WELL_KNOWN = ".well-known/stellar-history.json"

    def __init__(self, root: str):
        self.root = root

    def put_bytes(self, rel: str, data: bytes) -> None:
        path = os.path.join(self.root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def put_xdr_file(self, rel: str, records: List[bytes]) -> None:
        self.put_bytes(rel, gzip.compress(pack_xdr_stream(records)))

    def put_state(self, has: HistoryArchiveState) -> None:
        data = has.to_json().encode()
        self.put_bytes(self.WELL_KNOWN, data)
        self.put_bytes(category_path("history", has.current_ledger,
                                     suffix=".json"), data)

    def put_bucket(self, bucket: Bucket) -> None:
        if bucket.is_empty():
            return
        self.put_bytes(bucket_path(bucket.hash().hex()),
                       gzip.compress(bucket.serialize()))
