"""Catchup replay of a published history archive by the port's
CatchupManager, the way `python -m stellar_core_tpu_torch catchup
<last>/<count>` drives it: accel on the card, the configuration's chunk,
hot threshold and profile.

Set-up makes the archive from the seed with the frozen reference
(lib/archive.py) and makes one warm pass over the first payment ledgers,
which builds and warms the kernels.  The window replays the payment
ledgers again and again, each pass a new CatchupManager that applies the
first checkpoint's buckets (the accounts) and replays from there, after
the verify cache is cleared.  The window closes at the end of the first
ledger close that ends after --seconds; the rate is the ledgers closed
in it over its length, so a run never counts part of a ledger.  Every
ledger the window closes is compared with the reference: its hash, and
the result of each of its transactions (which every signature's verdict
decides: success or txBAD_AUTH)."""

from __future__ import annotations

import gc
import os
import shutil
import sys
import threading
import time

from ..lib import archive, harness
from ..lib import trace as tr

WORK = harness.ROOT / "build" / "portbench" / "work"


class Cell:
    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device=None, workdir=None):
        self.cfg, self.mix = cell["config"], cell["mix"]
        self.name = cell["workload"]["name"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        # None: the card; "cpu" runs the port's plain versions (tests)
        self.device = device
        self.workdir = str(workdir or WORK / self.name)
        self.records, self.errors, self.passes = [], [], 0
        self._pass = self._deadline = self._t_end = None
        self._stopped = False

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)
        os.makedirs(self.workdir)
        self.ref = archive.generate(self.cfg["archive"], self.seed,
                                    self.workdir)
        from stellar_core_tpu_torch.history.archive import FileHistoryArchive
        self.fa = FileHistoryArchive(self.ref["archive"])
        self.first, self.last = self.ref["replay"]
        # the warm pass, through the timed path: builds and loads the
        # kernels (its closes are not recorded: run() is not yet hooked)
        self._replay(self.first - 1 + self.mix["warm_ledgers"])

    def _replay(self, to_ledger=None):
        """One pass, as a new `catchup <last>/<count>` process makes it:
        the buckets of the checkpoint before the payment ledgers, then the
        replay of those up to `to_ledger` (all of them by default)."""
        to_ledger = to_ledger or self.last
        from stellar_core_tpu_torch.catchup.catchup import CatchupManager
        from stellar_core_tpu_torch.crypto import keys
        keys.clear_verify_cache()
        cm = CatchupManager(self.ref["nid"], self.ref["passphrase"],
                            accel=True, accel_device=self.device,
                            **self.cfg["catchup"])
        self._pass = self.passes
        try:
            return cm.catchup_recent(self.fa, to_ledger - self.first + 1,
                                     to_ledger=to_ledger)
        finally:
            self._pass = None

    # -- the window -------------------------------------------------------
    def run(self) -> dict:
        from stellar_core_tpu_torch.ledger.manager import LedgerManager
        orig = LedgerManager.close_ledger
        records, cell = self.records, self

        def close_ledger(mgr, *args, **kw):
            if cell._t_end is not None:
                # the window has closed: the pass ends before this ledger
                cell._stopped = True
                raise WindowClosed()
            t0 = time.time_ns()
            arts = orig(mgr, *args, **kw)
            if cell._pass is not None:
                t = time.perf_counter()
                # what the comparison needs, not the artifacts: a window
                # holding every closed ledger's transactions would grow
                # the heap that the collector walks during the window
                h = arts.header_entry
                records.append((cell._pass, t0, time.time_ns(), t,
                                h.header.ledgerSeq, h.hash, {
                                    pr.transactionHash:
                                    pr.result.result.switch.name
                                    for pr in
                                    arts.result_entry.txResultSet.results}))
                if t >= cell._deadline:
                    cell._t_end = t
            return arts

        self._pass, self._stopped, self._t_end = None, False, None
        gc.collect()  # set-up's garbage, so that no run's window pays it
        before = harness.registry_snapshot()
        trace = tr.DeviceTrace() if self.trace else None
        LedgerManager.close_ledger = close_ledger
        try:
            if trace is not None:
                trace.start()
            t_open = time.perf_counter()
            self._deadline = t_open + self.seconds
            while self._t_end is None:
                try:
                    self._replay()
                except Exception as e:
                    if not self._stopped:  # the program's own failure
                        self.errors.append(
                            f"pass {self.passes}: {e!r}"[:500])
                    break
                finally:
                    self.passes += 1
            t_end = self._t_end or time.perf_counter()
            _join_device_workers()
            if trace is not None:
                trace.stop()
        finally:
            LedgerManager.close_ledger = orig
        after = harness.registry_snapshot()
        registry = harness.registry_delta(before, after)
        window_s = t_end - t_open
        out = {"end_to_end": {
                   "replay_ledgers_per_s": len(records) / window_s},
               "registry": registry,
               "stats": {"ledgers_in_window": len(records),
                         "window_s": window_s, "passes": self.passes},
               "trace": trace}
        # the CPU's share of the apply's signature checks, in every run
        rec = registry.get("crypto.verify.recompute", 0)
        hit = registry.get("crypto.verify.cache-hit", 0)
        print(f"portbench: {len(records)} ledgers in {window_s:.3f} s, "
              f"{self.passes} passes; signature checks on the CPU "
              f"{rec} of {rec + hit}", file=sys.stderr)
        if trace is not None:
            out["breakdown"] = {
                "device_ops": tr.op_seconds(trace.ops),
                "idle_gaps": tr.idle_gaps(
                    trace.ops, trace.t0_ns, trace.t1_ns,
                    [(r[1], r[2], "host: ledger close "
                      "(LedgerManager.close_ledger)") for r in self.records],
                    "host: catchup between closes (bucket apply, archive "
                    "read, decode, pairing, verify dispatch and collect)")}
        return out

    def release(self) -> None:
        _join_device_workers()
        gc.collect()
        import torch
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- the comparison ---------------------------------------------------
    def check(self) -> dict:
        ref = self.ref["ledgers"]
        wrong_ledgers, wrong_results, out_of_order = 0, 0, 0
        expect = {}
        for p, _, _, _, seq, ledger_hash, codes in self.records:
            if seq != expect.get(p, self.first):
                out_of_order += 1
            expect[p] = seq + 1
            r = ref.get(seq)
            if r is None or ledger_hash != r["hash"]:
                wrong_ledgers += 1
            want = r["results"] if r is not None else {}
            wrong_results += sum(1 for h, c in want.items()
                                 if codes.get(h) != c) \
                + sum(1 for h in codes if h not in want)
        # every pass but the one the window cut ends on the last payment
        # ledger
        short = sum(1 for p in range(self.passes - self._stopped)
                    if expect.get(p) != self.last + 1)
        failed_passes = len(self.errors)
        checks = [("ledger_hash_mismatches", wrong_ledgers, 0),
                  ("tx_result_mismatches", wrong_results, 0),
                  ("ledgers_out_of_order", out_of_order, 0),
                  ("passes_short_of_tip", short, 0),
                  ("passes_failed", failed_passes, 0),
                  ("no_ledger_replayed", int(not self.records), 0)]
        correct = all(v <= lim for _, v, lim in checks)
        for e in self.errors:
            print(f"portbench: {e}", file=sys.stderr)
        return {"correct": correct, "attempted": len(self.records),
                "failed": wrong_ledgers + out_of_order + failed_passes,
                "checks": checks}


class WindowClosed(Exception):
    """Raised into a pass at its first close after the window."""


def _join_device_workers(timeout: float = 120.0) -> None:
    """Wait for the preverify pipelines' device threads to end."""
    deadline = time.monotonic() + timeout
    for t in threading.enumerate():
        if t.name == "preverify-device":
            t.join(max(0.0, deadline - time.monotonic()))
