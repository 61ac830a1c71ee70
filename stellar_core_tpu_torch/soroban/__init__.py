"""Soroban execution subsystem.

A bounded deterministic host for the sanctioned built-in host-function
subset (no wasm toolchain in this environment, per SURVEY §2.4), real
resource metering (cpu-instruction + memory budgets, per-tx resource
fees), full ExtendFootprintTTL / RestoreFootprint semantics over
CONTRACT_DATA / CONTRACT_CODE / TTL entries in BucketListDB,
generalized transaction sets (TransactionSetV1 phases with per-phase
surge pricing), and a footprint scheduler that partitions a Soroban
phase into disjoint write-set clusters applied as parallel batches.

Layout:
  config.py     SorobanNetworkConfig (process-wide resource limits)
  host.py       Budget + the built-in host-function table
  storage.py    footprint-enforcing storage view over a LedgerTxn
  ops.py        the three op frames (registered with operations.py)
  txset.py      generalized tx-set build / inspect helpers
  scheduler.py  write-set clustering + parallel batch apply
"""

from .config import SorobanNetworkConfig, network_config, set_network_config
from .host import Budget, BudgetExceeded, FootprintViolation, HostError
from .txset import (build_generalized_tx_set, decode_tx_set, is_generalized,
                    is_soroban_frame, tx_set_envelopes, tx_set_phases,
                    tx_set_previous_hash)
from .scheduler import cluster_footprints

__all__ = [
    "SorobanNetworkConfig", "network_config", "set_network_config",
    "Budget", "BudgetExceeded", "FootprintViolation", "HostError",
    "build_generalized_tx_set", "decode_tx_set", "is_generalized",
    "is_soroban_frame", "tx_set_envelopes", "tx_set_phases",
    "tx_set_previous_hash", "cluster_footprints",
]
