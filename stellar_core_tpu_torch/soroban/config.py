"""Soroban network configuration (resource limits + fee model).

Real stellar-core carries these in ConfigSettingEntry ledger entries
(upgradable via SCP).  Here they live in a process-wide object set from
Config at application startup: threading them through the ledger would
change genesis hashes and break every golden-hash fixture for zero
modelling benefit (the repo's ConfigSettingEntry is still the opaque
carrier from ledger_entries.py).  The values below mirror the pubnet
Phase-1 settings scaled to the simulated host's cost model.
"""

from dataclasses import dataclass

__all__ = ["SorobanNetworkConfig", "network_config", "set_network_config"]


@dataclass(frozen=True)
class SorobanNetworkConfig:
    # per-transaction budgets
    tx_max_instructions: int = 100_000_000
    tx_max_memory_bytes: int = 40 * 1024 * 1024
    tx_max_read_entries: int = 40
    tx_max_write_entries: int = 25
    tx_max_read_bytes: int = 200 * 1024
    tx_max_write_bytes: int = 128 * 1024
    # per-ledger (phase) admission limits
    ledger_max_tx_count: int = 100
    ledger_max_instructions: int = 500_000_000
    # fee model: deterministic price per resource unit (stroops)
    fee_per_instruction_increment: int = 25     # per 10k instructions
    fee_per_read_entry: int = 6_250
    fee_per_write_entry: int = 10_000
    fee_per_read_kb: int = 1_786
    fee_per_write_kb: int = 11_800
    # TTL / state archival
    min_temp_entry_ttl: int = 16
    min_persistent_entry_ttl: int = 120
    max_entry_ttl: int = 3_110_400

    def min_resource_fee(self, resources) -> int:
        """Deterministic model minimum for a SorobanResources declaration
        (the declared resourceFee must cover this or the tx is invalid)."""
        fp = resources.footprint
        fee = 0
        fee += (resources.instructions + 9_999) // 10_000 \
            * self.fee_per_instruction_increment
        fee += (len(fp.readOnly) + len(fp.readWrite)) * self.fee_per_read_entry
        fee += len(fp.readWrite) * self.fee_per_write_entry
        fee += (resources.readBytes + 1023) // 1024 * self.fee_per_read_kb
        fee += (resources.writeBytes + 1023) // 1024 * self.fee_per_write_kb
        return fee


_CONFIG = SorobanNetworkConfig()


def network_config() -> SorobanNetworkConfig:
    return _CONFIG


def set_network_config(cfg: SorobanNetworkConfig) -> None:
    global _CONFIG
    _CONFIG = cfg
