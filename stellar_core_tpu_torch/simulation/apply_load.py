"""ApplyLoad: maximum-throughput apply benchmark without consensus.

Reference: src/simulation/ApplyLoad.{h,cpp} + the `apply-load` CLI — build
a synthetic account universe, then close ledgers full of payments as fast
as the apply path allows, reporting tx/s, op/s and ledgers/s.  SCP, the
overlay and history are all bypassed: this isolates the tx-apply +
bucket-merge + hashing pipeline that bounds catchup replay (BASELINE.md
config #1's apply-side ceiling).

The copy of stellar_core_tpu/simulation/apply_load.py; it does no work
on the card (no signature is verified ahead of the close).
"""

from __future__ import annotations

import time

from ..ledger.manager import LedgerManager
from ..util.metrics import registry
from .loadgen import LoadGenerator


class ApplyLoad:
    def __init__(self, n_accounts: int = 1000, seed: int = 7,
                 network_id: bytes = b"\x5a" * 32):
        # invariants off: this is the max-throughput configuration the
        # reference uses (hash checks remain the oracle)
        self.mgr = LedgerManager(network_id, invariant_manager=None)
        self.mgr.start_new_ledger()
        self.lg = LoadGenerator(self.mgr, seed=seed)
        self.lg.create_accounts(n_accounts,
                                per_ledger=min(500, max(50, n_accounts)))

    def run(self, n_ledgers: int = 20, txs_per_ledger: int = 200,
            mode: str = "pay") -> dict:
        start_seq = self.mgr.last_closed_ledger_seq
        t0 = time.perf_counter()
        if mode == "pay":
            self.lg.payment_ledgers(n_ledgers, txs_per_ledger)
        else:
            self.lg.pretend_ledgers(n_ledgers, txs_per_ledger)
        dt = time.perf_counter() - t0
        n_txs = n_ledgers * txs_per_ledger
        close_timer = registry().timer("ledger.ledger.close").snapshot()
        return {
            "mode": mode,
            "ledgers": n_ledgers,
            "txs": n_txs,
            "seconds": round(dt, 3),
            "tx_per_s": round(n_txs / dt, 1),
            "ledgers_per_s": round(n_ledgers / dt, 2),
            "from_seq": start_seq,
            "to_seq": self.mgr.last_closed_ledger_seq,
            "ledger_close_timer": close_timer,
        }
