"""sqlite-backed durable node state.

Reference: src/database/Database.{h,cpp} (schema + transactions),
src/main/PersistentState.{h,cpp} (the storestate kv), plus the
ledgerheaders / scphistory / scpquorums / publishqueue tables that
LedgerManagerImpl::loadLastKnownLedger, HerderPersistence and
HistoryManagerImpl read on startup.

The reference runs over soci with postgres or sqlite; stdlib sqlite3 is the
only durable store here.  WAL journaling + NORMAL synchronous matches the
reference's sqlite pragmas (Database::applySchemaUpgrade sets
journal_mode=WAL); every mutation happens inside an explicit transaction
committed by the caller via `commit()` (ledger close calls it once per
close, after bucket files are on disk).
"""

from __future__ import annotations

import sqlite3
from typing import Iterable, List, Optional, Tuple

from .. import xdr as X
from ..util import logging as slog

_log = slog.get("Database")

SCHEMA_VERSION = 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS storestate (
    statename TEXT PRIMARY KEY,
    state     TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS ledgerheaders (
    ledgerhash TEXT PRIMARY KEY,
    prevhash   TEXT NOT NULL,
    ledgerseq  INTEGER UNIQUE NOT NULL,
    closetime  INTEGER NOT NULL,
    data       BLOB NOT NULL);
CREATE TABLE IF NOT EXISTS scphistory (
    ledgerseq INTEGER NOT NULL,
    envelope  BLOB NOT NULL);
CREATE TABLE IF NOT EXISTS scpquorums (
    qsethash      TEXT PRIMARY KEY,
    lastledgerseq INTEGER NOT NULL,
    qset          BLOB NOT NULL);
CREATE TABLE IF NOT EXISTS publishqueue (
    ledger INTEGER PRIMARY KEY,
    state  TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS storedtxsets (
    hash          TEXT PRIMARY KEY,
    lastledgerseq INTEGER NOT NULL,
    txset         BLOB NOT NULL);
CREATE TABLE IF NOT EXISTS txhistory (
    ledgerseq   INTEGER PRIMARY KEY,
    txentry     BLOB NOT NULL,
    resultentry BLOB NOT NULL);
CREATE TABLE IF NOT EXISTS peers (
    host        TEXT NOT NULL,
    port        INTEGER NOT NULL,
    numfailures INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (host, port));
CREATE TABLE IF NOT EXISTS ban (
    nodeid TEXT PRIMARY KEY);
CREATE INDEX IF NOT EXISTS scphistory_seq ON scphistory (ledgerseq);
"""


class PersistentState:
    """storestate keys (reference: PersistentState::Entry)."""
    LAST_CLOSED_LEDGER = "lastclosedledger"
    HISTORY_ARCHIVE_STATE = "historyarchivestate"
    LAST_SCP_DATA = "lastscpdata"
    DATABASE_SCHEMA = "databaseschema"
    NETWORK_PASSPHRASE = "networkpassphrase"


class Database:
    def __init__(self, path: str = ":memory:"):
        self.path = path
        self.conn = sqlite3.connect(path)
        self.conn.execute("PRAGMA journal_mode=WAL")
        self.conn.execute("PRAGMA synchronous=NORMAL")
        self.conn.executescript(_SCHEMA)
        cur = self.get_state(PersistentState.DATABASE_SCHEMA)
        if cur is None:
            self.set_state(PersistentState.DATABASE_SCHEMA,
                           str(SCHEMA_VERSION))
            self.conn.commit()
        elif int(cur) != SCHEMA_VERSION:
            raise RuntimeError(
                f"database schema {cur} != supported {SCHEMA_VERSION}")

    def close(self) -> None:
        self.conn.close()

    def commit(self) -> None:
        self.conn.commit()

    # -- storestate kv ------------------------------------------------------
    def set_state(self, name: str, value: str) -> None:
        self.conn.execute(
            "INSERT INTO storestate (statename, state) VALUES (?, ?) "
            "ON CONFLICT(statename) DO UPDATE SET state = excluded.state",
            (name, value))

    def get_state(self, name: str) -> Optional[str]:
        row = self.conn.execute(
            "SELECT state FROM storestate WHERE statename = ?",
            (name,)).fetchone()
        return row[0] if row else None

    # -- ledger headers ------------------------------------------------------
    def store_header(self, ledger_hash: bytes,
                     header: X.LedgerHeader) -> None:
        self.conn.execute(
            "INSERT OR REPLACE INTO ledgerheaders "
            "(ledgerhash, prevhash, ledgerseq, closetime, data) "
            "VALUES (?, ?, ?, ?, ?)",
            (ledger_hash.hex(), header.previousLedgerHash.hex(),
             header.ledgerSeq, header.scpValue.closeTime, header.to_xdr()))

    def load_header_by_hash(self, ledger_hash: bytes
                            ) -> Optional[X.LedgerHeader]:
        row = self.conn.execute(
            "SELECT data FROM ledgerheaders WHERE ledgerhash = ?",
            (ledger_hash.hex(),)).fetchone()
        return X.LedgerHeader.from_xdr(row[0]) if row else None

    def load_header_by_seq(self, seq: int) -> Optional[Tuple[bytes,
                                                             X.LedgerHeader]]:
        row = self.conn.execute(
            "SELECT ledgerhash, data FROM ledgerheaders WHERE ledgerseq = ?",
            (seq,)).fetchone()
        if row is None:
            return None
        return bytes.fromhex(row[0]), X.LedgerHeader.from_xdr(row[1])

    def max_header_seq(self) -> Optional[int]:
        row = self.conn.execute(
            "SELECT MAX(ledgerseq) FROM ledgerheaders").fetchone()
        return row[0]

    def delete_old_headers(self, keep_from_seq: int) -> None:
        self.conn.execute("DELETE FROM ledgerheaders WHERE ledgerseq < ?",
                          (keep_from_seq,))

    # -- SCP persistence (reference: HerderPersistence::saveSCPHistory) ------
    def save_scp_history(self, ledger_seq: int,
                         envelopes: Iterable[X.SCPEnvelope],
                         qsets: Iterable[X.SCPQuorumSet]) -> None:
        from ..crypto.sha import sha256
        self.conn.execute("DELETE FROM scphistory WHERE ledgerseq = ?",
                          (ledger_seq,))
        for env in envelopes:
            self.conn.execute(
                "INSERT INTO scphistory (ledgerseq, envelope) VALUES (?, ?)",
                (ledger_seq, env.to_xdr()))
        for qs in qsets:
            blob = qs.to_xdr()
            self.conn.execute(
                "INSERT OR REPLACE INTO scpquorums "
                "(qsethash, lastledgerseq, qset) VALUES (?, ?, ?)",
                (sha256(blob).hex(), ledger_seq, blob))

    def load_scp_history(self, ledger_seq: int) -> List[X.SCPEnvelope]:
        """Corrupt rows are skipped with a warning: SCP-state restore is
        best-effort (a node that restores nothing resyncs from peers)."""
        rows = self.conn.execute(
            "SELECT envelope FROM scphistory WHERE ledgerseq = ?",
            (ledger_seq,)).fetchall()
        out = []
        for r in rows:
            try:
                out.append(X.SCPEnvelope.from_xdr(r[0]))
            except Exception:
                _log.warning("skipping undecodable scphistory row for "
                             "slot %d", ledger_seq)
        return out

    def load_scp_quorums(self) -> List[X.SCPQuorumSet]:
        rows = self.conn.execute("SELECT qset FROM scpquorums").fetchall()
        out = []
        for r in rows:
            try:
                out.append(X.SCPQuorumSet.from_xdr(r[0]))
            except Exception:
                _log.warning("skipping undecodable scpquorums row")
        return out

    def save_txset(self, txset_hash: bytes, ledger_seq: int,
                   txset_xdr: bytes) -> None:
        self.conn.execute(
            "INSERT OR REPLACE INTO storedtxsets (hash, lastledgerseq, txset)"
            " VALUES (?, ?, ?)", (txset_hash.hex(), ledger_seq, txset_xdr))

    def load_txsets(self) -> List[Tuple[bytes, bytes]]:
        rows = self.conn.execute(
            "SELECT hash, txset FROM storedtxsets").fetchall()
        return [(bytes.fromhex(r[0]), r[1]) for r in rows]

    def prune_scp(self, below_seq: int) -> None:
        """Drop SCP history / tx sets for slots below `below_seq`
        (reference: HerderPersistence + MAX_SLOTS_TO_REMEMBER trimming)."""
        self.conn.execute("DELETE FROM scphistory WHERE ledgerseq < ?",
                          (below_seq,))
        self.conn.execute("DELETE FROM storedtxsets WHERE lastledgerseq < ?",
                          (below_seq,))

    # -- per-ledger history artifacts (reference: CheckpointBuilder's
    #    incremental .dirty streams; stored relationally here) --------------
    def save_tx_history(self, ledger_seq: int, tx_entry_xdr: bytes,
                        result_entry_xdr: bytes) -> None:
        self.conn.execute(
            "INSERT OR REPLACE INTO txhistory "
            "(ledgerseq, txentry, resultentry) VALUES (?, ?, ?)",
            (ledger_seq, tx_entry_xdr, result_entry_xdr))

    def load_tx_history(self, from_seq: int, to_seq: int
                        ) -> List[Tuple[int, bytes, bytes]]:
        return self.conn.execute(
            "SELECT ledgerseq, txentry, resultentry FROM txhistory "
            "WHERE ledgerseq BETWEEN ? AND ? ORDER BY ledgerseq",
            (from_seq, to_seq)).fetchall()

    def prune_tx_history(self, below_seq: int) -> None:
        self.conn.execute("DELETE FROM txhistory WHERE ledgerseq < ?",
                          (below_seq,))

    # -- peer address book (reference: PeerManager's peers table) -----------
    def store_peer(self, host: str, port: int, num_failures: int) -> None:
        self.conn.execute(
            "INSERT INTO peers (host, port, numfailures) VALUES (?, ?, ?) "
            "ON CONFLICT(host, port) DO UPDATE SET "
            "numfailures = excluded.numfailures", (host, port, num_failures))

    def load_peers(self) -> List[Tuple[str, int, int]]:
        return self.conn.execute(
            "SELECT host, port, numfailures FROM peers").fetchall()

    def delete_peer(self, host: str, port: int) -> None:
        self.conn.execute("DELETE FROM peers WHERE host = ? AND port = ?",
                          (host, port))

    # -- ban list (reference: BanManagerImpl's ban table) -------------------
    def store_ban(self, node_id: bytes) -> None:
        self.conn.execute("INSERT OR IGNORE INTO ban (nodeid) VALUES (?)",
                          (node_id.hex(),))

    def delete_ban(self, node_id: bytes) -> None:
        self.conn.execute("DELETE FROM ban WHERE nodeid = ?",
                          (node_id.hex(),))

    def load_bans(self) -> List[bytes]:
        return [bytes.fromhex(r[0]) for r in
                self.conn.execute("SELECT nodeid FROM ban").fetchall()]

    # -- publish queue (reference: HistoryManagerImpl publishqueue table) ----
    def queue_publish(self, checkpoint_ledger: int, has_json: str) -> None:
        self.conn.execute(
            "INSERT OR REPLACE INTO publishqueue (ledger, state) "
            "VALUES (?, ?)", (checkpoint_ledger, has_json))

    def publish_queue(self) -> List[Tuple[int, str]]:
        return self.conn.execute(
            "SELECT ledger, state FROM publishqueue ORDER BY ledger"
        ).fetchall()

    def dequeue_publish(self, checkpoint_ledger: int) -> None:
        self.conn.execute("DELETE FROM publishqueue WHERE ledger = ?",
                          (checkpoint_ledger,))
