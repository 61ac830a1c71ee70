"""Footprint-enforcing storage view over a LedgerTxn.

Every contract-data access the host performs goes through this layer,
which enforces three distinct disciplines:

1. **Footprint membership** — reads must hit readOnly ∪ readWrite,
   writes must hit readWrite.  An out-of-footprint access raises
   FootprintViolation (the tx traps; the node keeps closing).  This is
   what makes the footprint scheduler SOUND: a tx physically cannot
   touch state outside the cluster it was assigned to.
2. **Declared-resource caps** — materialized entry bytes are counted
   against the SorobanResources the tx declared (readBytes/writeBytes);
   crossing a declared cap is the structured RESOURCE_LIMIT_EXCEEDED
   failure, exactly like blowing the cpu budget.
3. **TTL liveness** — each CONTRACT_DATA/CONTRACT_CODE entry is paired
   with a TTL entry keyed by sha256 of the data key's XDR.  An expired
   TEMPORARY entry reads as absent; an expired PERSISTENT entry raises
   EntryArchived until RestoreFootprint brings it back.
"""

from __future__ import annotations

import hashlib
from typing import Optional

from .. import xdr as X
from .host import Budget, BudgetExceeded, EntryArchived, FootprintViolation

__all__ = ["FootprintStorage", "contract_data_key", "ttl_key",
           "ttl_key_for_xdr", "make_contract_data_entry", "make_ttl_entry"]


def contract_data_key(contract, key_scval, durability) -> X.LedgerKey:
    return X.LedgerKey.contractData(X.LedgerKeyContractData(
        contract=contract, key=key_scval, durability=durability))


def ttl_key_for_xdr(data_key_xdr: bytes) -> X.LedgerKey:
    return X.LedgerKey.ttl(X.LedgerKeyTtl(
        keyHash=hashlib.sha256(data_key_xdr).digest()))


def ttl_key(data_key: X.LedgerKey) -> X.LedgerKey:
    return ttl_key_for_xdr(data_key.to_xdr())


def make_contract_data_entry(contract, key_scval, durability, val,
                             last_modified: int = 0) -> X.LedgerEntry:
    return X.LedgerEntry(
        lastModifiedLedgerSeq=last_modified,
        data=X.LedgerEntryData.contractData(X.ContractDataEntry(
            ext=X.ExtensionPoint.v0(), contract=contract, key=key_scval,
            durability=durability, val=val)))


def make_ttl_entry(data_key_xdr: bytes, live_until: int,
                   last_modified: int = 0) -> X.LedgerEntry:
    return X.LedgerEntry(
        lastModifiedLedgerSeq=last_modified,
        data=X.LedgerEntryData.ttl(X.TTLEntry(
            keyHash=hashlib.sha256(data_key_xdr).digest(),
            liveUntilLedgerSeq=live_until)))


class FootprintStorage:
    """One transaction's storage lens: a LedgerTxn scoped by the declared
    LedgerFootprint, metering reads/writes against `resources`."""

    def __init__(self, ltx, contract, resources, net_cfg, budget: Budget,
                 ledger_seq: int):
        self.ltx = ltx
        self.contract = contract
        self.resources = resources
        self.net = net_cfg
        self.budget = budget
        self.ledger_seq = ledger_seq
        fp = resources.footprint
        self._ro = frozenset(k.to_xdr() for k in fp.readOnly)
        self._rw = frozenset(k.to_xdr() for k in fp.readWrite)
        self.read_bytes_used = 0
        self.write_bytes_used = 0
        self._read_keys = set()

    # -- footprint + metering gates ------------------------------------

    def _check_read(self, key_xdr: bytes) -> None:
        if key_xdr not in self._ro and key_xdr not in self._rw:
            raise FootprintViolation("read outside declared footprint")

    def _check_write(self, key_xdr: bytes) -> None:
        if key_xdr not in self._rw:
            raise FootprintViolation("write outside declared footprint")

    def _meter_read(self, nbytes: int) -> None:
        self.budget.charge("read_byte", nbytes)
        self.read_bytes_used += nbytes
        if self.read_bytes_used > self.resources.readBytes:
            raise BudgetExceeded(
                f"declared readBytes exceeded: {self.read_bytes_used} > "
                f"{self.resources.readBytes}")

    def _meter_write(self, nbytes: int) -> None:
        self.budget.charge("write_byte", nbytes)
        self.write_bytes_used += nbytes
        if self.write_bytes_used > self.resources.writeBytes:
            raise BudgetExceeded(
                f"declared writeBytes exceeded: {self.write_bytes_used} > "
                f"{self.resources.writeBytes}")

    # -- TTL -----------------------------------------------------------

    def _live_until(self, data_key_xdr: bytes) -> Optional[int]:
        got = self.ltx.load_by_bytes(ttl_key_for_xdr(data_key_xdr).to_xdr())
        return None if got is None else int(got.data.value.liveUntilLedgerSeq)

    def _load_live(self, key: X.LedgerKey, durability):
        """Load a data entry honoring TTL: expired TEMPORARY → None,
        expired PERSISTENT → EntryArchived."""
        key_xdr = key.to_xdr()
        entry = self.ltx.load_by_bytes(key_xdr)
        if entry is None:
            return None
        live_until = self._live_until(key_xdr)
        if live_until is not None and live_until < self.ledger_seq:
            if durability == X.ContractDataDurability.TEMPORARY:
                return None
            raise EntryArchived(
                f"persistent entry expired at {live_until} "
                f"(now {self.ledger_seq}); RestoreFootprint required")
        return entry

    def _min_ttl(self, durability) -> int:
        if durability == X.ContractDataDurability.TEMPORARY:
            return self.net.min_temp_entry_ttl
        return self.net.min_persistent_entry_ttl

    # -- host-facing API ----------------------------------------------

    def get(self, key_scval, durability):
        key = contract_data_key(self.contract, key_scval, durability)
        key_xdr = key.to_xdr()
        self._check_read(key_xdr)
        self.budget.charge("storage_read")
        entry = self._load_live(key, durability)
        if entry is None:
            return None
        if key_xdr not in self._read_keys:
            self._read_keys.add(key_xdr)
            self._meter_read(len(entry.to_xdr()))
        return entry.data.value.val

    def has(self, key_scval, durability) -> bool:
        key = contract_data_key(self.contract, key_scval, durability)
        self._check_read(key.to_xdr())
        self.budget.charge("storage_has")
        return self._load_live(key, durability) is not None

    def put(self, key_scval, durability, val) -> None:
        key = contract_data_key(self.contract, key_scval, durability)
        key_xdr = key.to_xdr()
        self._check_write(key_xdr)
        self.budget.charge("storage_write")
        existing = self.ltx.load_by_bytes(key_xdr)
        live_until = self._live_until(key_xdr)
        expired = live_until is not None and live_until < self.ledger_seq
        if existing is not None and expired \
                and durability == X.ContractDataDurability.PERSISTENT:
            raise EntryArchived("cannot overwrite archived persistent entry")
        entry = make_contract_data_entry(
            self.contract, key_scval, durability, val,
            last_modified=self.ledger_seq)
        self._meter_write(len(entry.to_xdr()))
        if existing is None:
            self.ltx.create(entry)
        else:
            self.ltx.update(entry)
        # (re)arm the TTL: new entries get the durability minimum; an
        # overwrite of an expired TEMPORARY is a logical re-create
        if live_until is None or expired:
            ttl_entry = make_ttl_entry(
                key_xdr, self.ledger_seq + self._min_ttl(durability) - 1,
                last_modified=self.ledger_seq)
            self.ltx.put(ttl_entry)

    def delete(self, key_scval, durability) -> None:
        key = contract_data_key(self.contract, key_scval, durability)
        key_xdr = key.to_xdr()
        self._check_write(key_xdr)
        self.budget.charge("storage_del")
        entry = self._load_live(key, durability)
        if entry is None:
            return
        self.ltx.erase(key)
        if self.ltx.load_by_bytes(ttl_key_for_xdr(key_xdr).to_xdr()) \
                is not None:
            self.ltx.erase(ttl_key_for_xdr(key_xdr))
