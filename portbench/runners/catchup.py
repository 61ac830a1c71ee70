"""Catchup replay of a published history archive by the port's
CatchupManager, the way `python -m stellar_core_tpu_torch catchup
<last>/<count>` drives it: accel on the card, the configuration's chunk,
hot threshold and profile, and whichever apply path the port takes (its
Python close, or the native engine where that loads).

Set-up makes the archive from the seed with the frozen reference
(lib/archive.py) and makes one warm pass over the first payment ledgers,
which builds and warms the kernels.  The window replays the payment
ledgers again and again, each pass a new CatchupManager that applies the
first checkpoint's buckets (the accounts) and replays from there, after
the verify cache is cleared.  The window is made of whole passes: it
closes at the end of the first pass that ends after --seconds, and the
rate is the ledgers its passes replayed (each pass's returned last closed
ledger less the one before the range) over its length.  Each pass is
compared with the reference by what catchup_recent returns: its last
closed ledger's hash, which chains every header of the range (each
committing its result set and its bucket list), and the balance and
sequence number of every account, which every transaction's verdict
decides (success, txBAD_AUTH or txFAILED)."""

from __future__ import annotations

import gc
import os
import shutil
import sys
import threading
import time

import numpy as np

from ..lib import archive, harness, ledgers
from ..lib import trace as tr

WORK = harness.ROOT / "build" / "portbench" / "work"

# the program's spans that label the device's idle gaps, innermost first:
# a gap's time goes to the innermost span that covers it
HOST_SPANS = (
    ("ledger.close", "host: ledger close (ledger.close, the Python path)"),
    ("catchup.apply-checkpoint", "host: checkpoint apply outside the "
     "closes (catchup.apply-checkpoint: the collect; the native engine's "
     "whole apply)"),
    ("catchup.bucket-apply", "host: bucket apply (catchup.bucket-apply)"))
OTHER = ("host: catchup outside those spans (archive read and decode, "
         "pairing, verify dispatch, the engine's state export, the "
         "runner's read of each pass's accounts)")
# the program's span buffer holds 65,536 spans, and a pass on the Python
# path leaves about 4,500 (a close, its phases and its first 256
# transactions' spans), so a fast host's traced window would evict some,
# and the readers of spans read None where it did: a traced window holds
# up to this many (the buffer keeps what the window makes, no more)
TRACED_SPAN_BUDGET = 262_144
# CatchupManager.stats of the native engine's own verify cache, summed
# over the window's passes (zero on the Python path)
NATIVE_STATS = ("native_verify_cache_misses", "native_verify_cache_hits",
                "native_checkpoints")


class Cell:
    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device=None, workdir=None):
        self.cfg, self.mix = cell["config"], cell["mix"]
        self.name = cell["workload"]["name"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        # None: the card; "cpu" runs the port's plain versions (tests)
        self.device = device
        self.workdir = str(workdir or WORK / self.name)
        # one (last closed ledger, its hash, balances, sequence numbers)
        # a pass that returned
        self.results, self.errors, self.passes = [], [], 0

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
        # kernels (outside the window: nothing of it is compared)
        self._replay(self.first - 1 + self.mix["warm_ledgers"])

    def _replay(self, to_ledger=None):
        """One pass, as a new `catchup <last>/<count>` process makes it:
        the buckets of the checkpoint before the payment ledgers, then the
        replay of those up to `to_ledger` (all of them by default).
        Returns the CatchupManager and the LedgerManager it left."""
        to_ledger = to_ledger or self.last
        from stellar_core_tpu_torch.catchup.catchup import CatchupManager
        from stellar_core_tpu_torch.crypto import keys
        keys.clear_verify_cache()
        cm = CatchupManager(self.ref["nid"], self.ref["passphrase"],
                            accel=True, accel_device=self.device,
                            **self.cfg["catchup"])
        return cm, cm.catchup_recent(self.fa, to_ledger - self.first + 1,
                                     to_ledger=to_ledger)

    # -- the window -------------------------------------------------------
    def run(self) -> dict:
        keys = self.ref["accounts"][0]
        native = dict.fromkeys(NATIVE_STATS, 0)
        self.results, self.errors, self.passes = [], [], 0
        read_s = 0.0  # the runner's own reads of the passes' accounts
        gc.collect()  # set-up's garbage, so that no run's window pays it
        before = harness.registry_snapshot()
        trace = tr.DeviceTrace() if self.trace else None
        if trace is not None:
            from stellar_core_tpu_torch.util import tracing
            spans = tracing.trace_buffer()
            spans.max_spans = max(spans.max_spans, TRACED_SPAN_BUDGET)
            trace.start()
        t_open = time.perf_counter()
        deadline = t_open + self.seconds
        while True:
            self.passes += 1
            try:
                cm, mgr = self._replay()
            except Exception as e:  # the program's own failure
                self.errors.append(f"pass {self.passes - 1}: {e!r}"[:500])
                break
            t_read = time.perf_counter()
            self.results.append((mgr.last_closed_ledger_seq, mgr.lcl_hash,
                                 *ledgers.read_accounts(mgr.root, keys)))
            read_s += time.perf_counter() - t_read
            for k in NATIVE_STATS:
                native[k] += cm.stats.get(k, 0)
            del cm, mgr
            if time.perf_counter() >= deadline:
                break
        t_end = time.perf_counter()
        _join_device_workers()
        if trace is not None:
            trace.stop()
        after = harness.registry_snapshot()
        registry = harness.registry_delta(before, after)
        window_s = t_end - t_open
        n_ledgers = self._ledgers()
        out = {"end_to_end": {"replay_ledgers_per_s": n_ledgers / window_s},
               "registry": registry,
               "stats": {"ledgers_in_window": n_ledgers,
                         "window_s": window_s, "passes": self.passes,
                         "account_read_s": read_s, **native},
               "trace": trace}
        # the CPU's share of the apply's signature checks, in every run
        rec = registry.get("crypto.verify.recompute", 0) \
            + native["native_verify_cache_misses"]
        hit = registry.get("crypto.verify.cache-hit", 0) \
            + native["native_verify_cache_hits"]
        print(f"portbench: {n_ledgers} ledgers in {window_s:.3f} s, "
              f"{self.passes} passes, {native['native_checkpoints']} "
              f"checkpoints on the native engine, {read_s:.3f} s reading "
              f"accounts; signature checks on the CPU {rec} of {rec + hit}",
              file=sys.stderr)
        if trace is not None:
            out["breakdown"] = {
                "device_ops": tr.op_seconds(trace.ops),
                "idle_gaps": tr.idle_gaps(
                    trace.ops, trace.t0_ns, trace.t1_ns,
                    _host_spans(trace, registry), OTHER)}
        return out

    def release(self) -> None:
        _join_device_workers()
        gc.collect()
        import torch
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _ledgers(self) -> int:
        """The ledgers the window's passes replayed: each pass's returned
        last closed ledger less the one before the range."""
        return sum(seq - (self.first - 1) for seq, *_ in self.results)

    # -- the comparison ---------------------------------------------------
    def check(self) -> dict:
        ref = self.ref["ledgers"]
        _, ref_bal, ref_seq = self.ref["accounts"]
        wrong_ledgers = wrong_accounts = out_of_order = short = 0
        for seq, lcl_hash, bal, seqs in self.results:
            r = ref.get(seq)
            if r is None or lcl_hash != r["hash"]:
                wrong_ledgers += 1
            wrong_accounts += int(np.count_nonzero(
                (bal != ref_bal) | (seqs != ref_seq)))
            out_of_order += seq != self.last
            short += seq < self.last
        failed_passes = len(self.errors)
        n_ledgers = self._ledgers()
        checks = [("ledger_hash_mismatches", wrong_ledgers, 0),
                  ("tx_result_mismatches", wrong_accounts, 0),
                  ("ledgers_out_of_order", out_of_order, 0),
                  # a pass that failed did not reach the tip either
                  ("passes_short_of_tip", short + failed_passes, 0),
                  ("passes_failed", failed_passes, 0),
                  ("no_ledger_replayed", int(n_ledgers <= 0), 0)]
        correct = all(v <= lim for _, v, lim in checks)
        for e in self.errors:
            print(f"portbench: {e}", file=sys.stderr)
        return {"correct": correct, "attempted": n_ledgers,
                "failed": wrong_ledgers + out_of_order + failed_passes,
                "checks": checks}


def _host_spans(trace, registry) -> list:
    """(start_ns, end_ns, label) host intervals of the traced window from
    the program's HOST_SPANS, none overlapping; none where the program's
    span buffer evicted spans in the window or it has no spans_between,
    so that no gap is given a label it may not have."""
    if registry.get("tracing.spans-evicted", 0) > 0:
        return []
    try:
        from stellar_core_tpu_torch.util.tracing import spans_between
    except ImportError:
        return []
    return tr.innermost([
        [(s, e, label) for s, e, _ in
         spans_between(trace.t0_ns, trace.t1_ns, name)]
        for name, label in HOST_SPANS])


def _join_device_workers(timeout: float = 120.0) -> None:
    """Wait for the preverify pipelines' device threads to end."""
    deadline = time.monotonic() + timeout
    for t in threading.enumerate():
        if t.name == "preverify-device":
            t.join(max(0.0, deadline - time.monotonic()))
