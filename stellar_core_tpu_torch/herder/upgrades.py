"""Upgrades — consensus-voted ledger parameter changes.

Reference: src/herder/Upgrades.{h,cpp} — createUpgradesFor, isValid,
applyTo, toString, removeUpgrades; UpgradeParameters (the node's desired
targets from config, with an expiration time).  Key design point preserved
(SURVEY.md §5.6): consensus-critical parameters (protocol version, base
fee, max tx set size, base reserve) change ONLY via SCP-voted upgrades
carried in StellarValue.upgrades, never via local config directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .. import xdr as X
from ..util import logging as slog

log = slog.get("Herder")

UT = X.LedgerUpgradeType

# This build's max supported protocol (classic semantics; Soroban gap
# documented in SURVEY.md §2.4)
CURRENT_LEDGER_PROTOCOL_VERSION = 23


@dataclass
class UpgradeParameters:
    """The operator's desired upgrade targets (config / HTTP `/upgrades`).
    Reference: Upgrades::UpgradeParameters."""
    upgrade_time: int = 0                    # unix time the vote activates
    protocol_version: Optional[int] = None
    base_fee: Optional[int] = None
    max_tx_set_size: Optional[int] = None
    base_reserve: Optional[int] = None
    flags: Optional[int] = None


class Upgrades:
    def __init__(self, params: Optional[UpgradeParameters] = None):
        self.params = params or UpgradeParameters()

    def set_parameters(self, params: Optional[UpgradeParameters]) -> None:
        self.params = params or UpgradeParameters()

    def pending_json(self) -> dict:
        """The `/upgrades?mode=get` payload (reference:
        CommandHandler::upgrades get mode)."""
        p = self.params
        return {
            "upgradetime": p.upgrade_time,
            "protocolversion": p.protocol_version,
            "basefee": p.base_fee,
            "maxtxsetsize": p.max_tx_set_size,
            "basereserve": p.base_reserve,
            "flags": p.flags,
        }

    # ------------------------------------------------------------------
    def create_upgrades_for(self, header: X.LedgerHeader,
                            close_time: int) -> List[bytes]:
        """Upgrades to vote for in the next StellarValue (each serialized
        as an opaque UpgradeType blob).  Reference: Upgrades::createUpgradesFor."""
        p = self.params
        if close_time < p.upgrade_time:
            return []
        out: List[bytes] = []
        if p.protocol_version is not None \
                and p.protocol_version != header.ledgerVersion:
            out.append(X.LedgerUpgrade.newLedgerVersion(
                p.protocol_version).to_xdr())
        if p.base_fee is not None and p.base_fee != header.baseFee:
            out.append(X.LedgerUpgrade.newBaseFee(p.base_fee).to_xdr())
        if p.max_tx_set_size is not None \
                and p.max_tx_set_size != header.maxTxSetSize:
            out.append(X.LedgerUpgrade.newMaxTxSetSize(
                p.max_tx_set_size).to_xdr())
        if p.base_reserve is not None \
                and p.base_reserve != header.baseReserve:
            out.append(X.LedgerUpgrade.newBaseReserve(p.base_reserve).to_xdr())
        return out

    # ------------------------------------------------------------------
    def is_valid(self, upgrade_bytes: bytes, header: X.LedgerHeader,
                 nomination: bool, close_time: int = 0) -> bool:
        """Would we accept this upgrade in a value?  During nomination we
        only vote for upgrades we actively want; during the ballot protocol
        we accept any well-formed upgrade that doesn't regress the ledger.
        Reference: Upgrades::isValid / isValidForApply."""
        try:
            up = X.LedgerUpgrade.from_xdr(upgrade_bytes)
        except X.XdrError:
            return False
        if not self._valid_for_apply(up, header):
            return False
        if nomination:
            return self._wanted(up, header, close_time)
        return True

    @staticmethod
    def _valid_for_apply(up, header: X.LedgerHeader) -> bool:
        t = up.switch
        if t == UT.LEDGER_UPGRADE_VERSION:
            v = up.newLedgerVersion
            return (header.ledgerVersion < v
                    <= CURRENT_LEDGER_PROTOCOL_VERSION)
        if t == UT.LEDGER_UPGRADE_BASE_FEE:
            return up.newBaseFee > 0
        if t == UT.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
            return up.newMaxTxSetSize > 0
        if t == UT.LEDGER_UPGRADE_BASE_RESERVE:
            return up.newBaseReserve > 0
        return False  # flags/config upgrades not supported in this build

    def _wanted(self, up, header: X.LedgerHeader, close_time: int) -> bool:
        p = self.params
        if close_time and close_time < p.upgrade_time:
            return False
        t = up.switch
        if t == UT.LEDGER_UPGRADE_VERSION:
            return p.protocol_version == up.newLedgerVersion
        if t == UT.LEDGER_UPGRADE_BASE_FEE:
            return p.base_fee == up.newBaseFee
        if t == UT.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
            return p.max_tx_set_size == up.newMaxTxSetSize
        if t == UT.LEDGER_UPGRADE_BASE_RESERVE:
            return p.base_reserve == up.newBaseReserve
        return False

    # ------------------------------------------------------------------
    @staticmethod
    def apply_to(upgrade_bytes: bytes, header: X.LedgerHeader) -> None:
        """Mutate the in-flight ledger header per one voted upgrade.
        Reference: Upgrades::applyTo (the LedgerTxn header part; per-entry
        side effects like reserve-driven liability updates are out of this
        build's classic scope)."""
        up = X.LedgerUpgrade.from_xdr(upgrade_bytes)
        t = up.switch
        if t == UT.LEDGER_UPGRADE_VERSION:
            header.ledgerVersion = up.newLedgerVersion
        elif t == UT.LEDGER_UPGRADE_BASE_FEE:
            header.baseFee = up.newBaseFee
        elif t == UT.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
            header.maxTxSetSize = up.newMaxTxSetSize
        elif t == UT.LEDGER_UPGRADE_BASE_RESERVE:
            header.baseReserve = up.newBaseReserve
        else:
            log.warning("ignoring unsupported upgrade type %s", t)

    @staticmethod
    def apply_to_checked(upgrade_bytes: bytes, header: X.LedgerHeader) -> bool:
        """applyTo with apply-time re-validation: malformed or
        invalid-for-apply upgrades are logged and skipped (never crash a
        ledger close in flight).  Reference: Upgrades::applyTo error
        handling in applyLedger."""
        try:
            up = X.LedgerUpgrade.from_xdr(upgrade_bytes)
        except Exception:
            log.error("skipping malformed upgrade in externalized value")
            return False
        if not Upgrades._valid_for_apply(up, header):
            log.error("skipping invalid-for-apply upgrade: %s",
                      Upgrades.describe(upgrade_bytes))
            return False
        Upgrades.apply_to(upgrade_bytes, header)
        return True

    @staticmethod
    def describe(upgrade_bytes: bytes) -> str:
        try:
            up = X.LedgerUpgrade.from_xdr(upgrade_bytes)
        except X.XdrError:
            return "<malformed>"
        t = up.switch
        if t == UT.LEDGER_UPGRADE_VERSION:
            return f"protocolversion={up.newLedgerVersion}"
        if t == UT.LEDGER_UPGRADE_BASE_FEE:
            return f"basefee={up.newBaseFee}"
        if t == UT.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
            return f"maxtxsetsize={up.newMaxTxSetSize}"
        if t == UT.LEDGER_UPGRADE_BASE_RESERVE:
            return f"basereserve={up.newBaseReserve}"
        return str(t)
