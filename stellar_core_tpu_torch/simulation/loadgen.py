"""LoadGenerator: synthetic traffic for tests and benchmarks.

Reference: src/simulation/LoadGenerator.{h,cpp} — modes: create accounts /
pay / pretend (we add per-ledger batching identical in spirit to
generateLoad's txrate pacing, minus the timer loop: callers drive ledgers
explicitly), plus a Soroban invoke mode over the bounded host:
``AdmissionCampaign(soroban_mix=...)`` blends InvokeHostFunction traffic
into the paced admission stream, and ``SorobanMixCampaign`` closes the
same seed-derived mixed tx sets under serial AND footprint-parallel
apply, asserting per-close bucket-list hash identity.

Sustained-ingestion additions (ROADMAP item 3):

- ``SeedAccountPool`` — millions of distinct accounts in O(1) RAM: account
  i's key is derived from (seed, i) on demand, never stored;
- ``LoadGenerator.install_account_pool`` — materializes the pool straight
  into the bucket list in bounded chunks through
  ``LedgerManager.close_ledger_synthetic`` (no CreateAccount replay; over
  BucketListDB the pool lives in indexed on-disk bucket files, which is
  what the disk-resident bucket work was for);
- ``AdmissionCampaign`` — paced submission through the batched admission
  pipeline (herder/admission.py) rather than pre-built ledgers: offered
  load per close target, admission verdicts counted, sustained TPS and
  queue-depth behavior measured, overload answered by try-again-later.
  ``accel_device`` is its pipeline's (herder/admission.py): None the
  card, "cpu" the plain versions.

Close times are derived from the injected VirtualClock (or advanced by
``close_target`` from the LCL when no clock is injected) — never from a
hardcoded wall-clock constant.
"""

from __future__ import annotations

import random
import time as _time  # perf_counter only (campaign wall-clock reporting)
from typing import Dict, List, Optional

from .. import xdr as X
from ..crypto.keys import SecretKey
from ..crypto.sha import sha256
from ..history.manager import HistoryManager
from ..ledger.manager import LedgerManager
from ..testutils import (TestAccount, build_tx, create_account_op,
                         native_payment_op)

DEFAULT_CLOSE_TARGET_S = 5  # reference: EXP_LEDGER_TIMESPAN_SECONDS


class LoadGenerator:
    def __init__(self, mgr: LedgerManager,
                 history: Optional[HistoryManager] = None, seed: int = 1,
                 clock=None, close_target: int = DEFAULT_CLOSE_TARGET_S):
        """``clock``: an optional VirtualClock — close times then track
        ``clock.system_now()``; without one they advance by
        ``close_target`` per close from the LCL's own closeTime."""
        self.mgr = mgr
        self.history = history
        self.rng = random.Random(seed)
        self.clock = clock
        self.close_target = close_target
        root_sk = mgr.root_account_secret()
        root_entry = mgr.root.get_entry(
            X.LedgerKey.account(X.LedgerKeyAccount(
                accountID=X.AccountID.ed25519(
                    root_sk.public_key.ed25519))).to_xdr())
        self.root = TestAccount(mgr, root_sk, root_entry.data.value.seqNum)
        self.accounts: List[TestAccount] = []

    def _next_close_time(self) -> int:
        """Monotone close time derived from the injected clock (or the
        configured close target), never a wall-clock constant."""
        floor = int(self.mgr.lcl_header.scpValue.closeTime) + 1
        if self.clock is not None:
            return max(floor, int(self.clock.system_now()))
        return max(floor,
                   int(self.mgr.lcl_header.scpValue.closeTime)
                   + self.close_target)

    def _close(self, frames) -> None:
        arts = self.mgr.close_ledger(frames, self._next_close_time())
        if self.history is not None:
            self.history.ledger_closed(arts)

    def close_empty_ledger(self) -> None:
        self._close([])

    def create_accounts(self, n: int, per_ledger: int = 50,
                        balance: int = 10_000_000_000) -> None:
        from ..xdr.transaction import MAX_OPS_PER_TX
        created = 0
        while created < n:
            batch = min(per_ledger, n - created)
            ops = []
            new_accounts = []
            for _ in range(batch):
                sk = SecretKey.pseudo_random_for_testing(self.rng)
                ops.append(create_account_op(
                    X.AccountID.ed25519(sk.public_key.ed25519), balance))
                new_accounts.append(sk)
            # a ledger batch larger than the per-tx op cap splits into
            # several root txs within the same ledger
            frames = [self.root.tx(ops[j:j + MAX_OPS_PER_TX])
                      for j in range(0, len(ops), MAX_OPS_PER_TX)]
            self._close(frames)
            header = self.mgr.lcl_header
            for sk in new_accounts:
                self.accounts.append(TestAccount(
                    self.mgr, sk, (header.ledgerSeq) << 32))
            created += batch

    def payment_ledgers(self, n_ledgers: int, txs_per_ledger: int = 20) -> None:
        assert len(self.accounts) >= 2, "create accounts first"
        for _ in range(n_ledgers):
            frames = []
            for _ in range(txs_per_ledger):
                src, dst = self.rng.sample(self.accounts, 2)
                amount = self.rng.randrange(1, 1_000_000)
                frames.append(src.tx([native_payment_op(dst.account_id,
                                                        amount)]))
            self._close(frames)

    def pretend_ledgers(self, n_ledgers: int, txs_per_ledger: int = 20,
                        ops_per_tx: int = 3) -> None:
        """'Pretend' mode: load-shaped but state-light traffic — each tx
        carries benign ManageData/BumpSequence ops (reference: LoadGenerator
        LOAD_PRETEND mode's setOptions/manageData fillers)."""
        assert self.accounts, "create accounts first"
        for _ in range(n_ledgers):
            frames = []
            for _ in range(txs_per_ledger):
                src = self.rng.choice(self.accounts)
                ops = []
                for k in range(ops_per_tx):
                    if self.rng.random() < 0.5:
                        name = f"pretend-{self.rng.randrange(4)}"
                        ops.append(X.Operation(
                            sourceAccount=None,
                            body=X.OperationBody.manageDataOp(
                                X.ManageDataOp(
                                    dataName=name.encode(),
                                    dataValue=bytes([self.rng.randrange(
                                        256)]) * 8))))
                    else:
                        ops.append(X.Operation(
                            sourceAccount=None,
                            body=X.OperationBody.bumpSequenceOp(
                                X.BumpSequenceOp(bumpTo=0))))
                frames.append(src.tx(ops))
            self._close(frames)

    def run_to_checkpoint_boundary(self) -> None:
        """Close empty ledgers until a checkpoint publishes (seq ≡ 63 mod 64)."""
        from ..history.archive import is_checkpoint_boundary
        while not is_checkpoint_boundary(self.mgr.last_closed_ledger_seq):
            self.close_empty_ledger()

    def run_checkpoints(self, n: int, txs_per_ledger: int = 0) -> None:
        """Advance the chain through `n` MORE published checkpoint
        boundaries — payment traffic when txs_per_ledger > 0 (needs
        accounts), empty closes otherwise.  The cheap way to grow the
        multi-checkpoint archives range-parallel catchup and its bench
        replay (each range needs whole checkpoints to own)."""
        from ..history.archive import is_checkpoint_boundary
        done = 0
        while done < n:
            if txs_per_ledger > 0 and len(self.accounts) >= 2:
                self.payment_ledgers(1, txs_per_ledger)
            else:
                self.close_empty_ledger()
            if is_checkpoint_boundary(self.mgr.last_closed_ledger_seq):
                done += 1

    # ------------------------------------------------------------------
    # seed-derived account pools (millions of accounts, O(1) RAM)
    # ------------------------------------------------------------------
    def install_account_pool(self, pool: "SeedAccountPool",
                             chunk: int = 20_000) -> None:
        """Materialize `pool` into the ledger in bounded chunks via the
        synthetic-close seam — at no point do more than `chunk` decoded
        entries exist for the install (the bucket list's residency policy
        bounds what the merges keep decoded)."""
        if self.history is not None:
            # synthetic closes emit no ClosedLedgerArtifacts to publish:
            # silently advancing past the archive would leave a broken
            # header chain in the next checkpoint
            raise ValueError(
                "install_account_pool is incompatible with a history "
                "archive: synthetic closes produce no publishable "
                "artifacts (use a LoadGenerator without history)")
        for lo in range(0, pool.n, chunk):
            hi = min(pool.n, lo + chunk)
            self.mgr.close_ledger_synthetic(
                [pool.entry(i) for i in range(lo, hi)],
                self._next_close_time())


class SeedAccountPool:
    """O(1)-RAM pool of `n` seed-derived accounts.

    Account i's secret key is SHA256(tag, seed, i) — derived on demand,
    never stored; the pool object holds only the seed, the size and a
    sequence-number dict for the (bounded) set of accounts a campaign has
    actually touched.  Entries install with seqNum 0 so derived sequence
    numbers are position-independent (chunked installs land accounts in
    different ledgers).
    """

    def __init__(self, n: int, seed: int = 1,
                 balance: int = 10_000_000_000):
        self.n = n
        self.seed = seed
        self.balance = balance
        self._touched: Dict[int, int] = {}   # index -> last used seq num

    def secret(self, i: int) -> SecretKey:
        return SecretKey(sha256(
            b"loadgen account pool %d %d" % (self.seed, i)))

    def account_id(self, i: int) -> X.AccountID:
        return X.AccountID.ed25519(self.secret(i).public_key.ed25519)

    def entry(self, i: int) -> X.LedgerEntry:
        return X.LedgerEntry(
            lastModifiedLedgerSeq=1,
            data=X.LedgerEntryData.account(X.AccountEntry(
                accountID=self.account_id(i), balance=self.balance,
                seqNum=0)))

    def next_seq(self, i: int) -> int:
        cur = self._touched.get(i, 0) + 1
        self._touched[i] = cur
        return cur

    @property
    def touched(self) -> int:
        return len(self._touched)


class AdmissionCampaign:
    """Paced load through the batched admission pipeline over BucketListDB.

    One node's ingestion path without consensus: txs from a seed-derived
    account pool are offered to ``AdmissionPipeline.submit`` in per-close
    rounds, the pipeline batches/verifies/back-pressures, and each round
    closes a ledger from ``tx_queue.tx_set_frames()`` (surge-priced) like
    the herder would.  Reports sustained TPS, admission latency
    percentiles, batch-size distribution, per-status counts and
    queue-depth behavior — the bench ``admission`` section and the load
    tests both drive this.
    """

    def __init__(self, n_accounts: int, workdir: Optional[str] = None,
                 seed: int = 7, accel: bool = False,
                 batch_size: int = 256, flush_delay_s: float = 0.05,
                 max_backlog: int = 4096,
                 max_tx_set_ops: int = 1000,
                 entry_cache_size: int = 8192,
                 resident_levels: int = 1,
                 install_chunk: int = 20_000,
                 network_passphrase: str = "admission campaign",
                 soroban_mix: float = 0.0, accel_device=None):
        from ..herder.admission import AdmissionPipeline
        from ..herder.tx_queue import TransactionQueue
        from ..util.clock import ClockMode, VirtualClock

        self.nid = sha256(network_passphrase.encode())
        self.clock = VirtualClock(ClockMode.VIRTUAL_TIME)
        self.store = None
        if workdir is not None:
            from ..bucket.manager import BucketListStore
            self.store = BucketListStore(workdir)
        # invariants off — max-throughput configuration, like ApplyLoad
        self.mgr = LedgerManager(self.nid, invariant_manager=None,
                                 bucket_store=self.store,
                                 entry_cache_size=entry_cache_size,
                                 resident_levels=resident_levels)
        self.mgr.start_new_ledger()
        # campaign ledgers carry up to max_tx_set_ops ops (surge-pricing
        # trim limit; the queue bounds itself at 4x this)
        self.mgr.lcl_header.maxTxSetSize = max_tx_set_ops
        self.lg = LoadGenerator(self.mgr, seed=seed, clock=self.clock)
        self.pool = SeedAccountPool(n_accounts, seed=seed)
        self.lg.install_account_pool(self.pool, chunk=install_chunk)
        self.rng = random.Random(seed ^ 0x5eed)
        self.tx_queue = TransactionQueue(self.mgr)
        self.admission = AdmissionPipeline(
            self.tx_queue, self.mgr, self.clock, accel=accel,
            batch_size=batch_size, flush_delay_s=flush_delay_s,
            max_backlog=max_backlog, accel_device=accel_device)
        # soroban_mix: fraction of offered txs that are InvokeHostFunction
        # invokes against a per-account contract (the Soroban traffic-mix
        # knob) — they ride the tx queue's resource-limited
        # Soroban lane and close as the generalized set's second phase
        self.soroban_mix = soroban_mix
        self.soroban_offered = 0
        self.statuses: Dict[str, int] = {}
        self.peak_queue_depth = 0
        self.peak_admission_depth = 0
        self.backpressure_engaged = 0

    def _payment_frame(self, i: int, j: int):
        return build_tx(self.nid, self.pool.secret(i), self.pool.next_seq(i),
                        [native_payment_op(self.pool.account_id(j), 100)],
                        fee=100 + self.rng.randrange(200))

    def _soroban_frame(self, i: int):
        return _soroban_pool_frame(self.nid, self.pool, i,
                                   self.rng.randrange(2 ** 32))

    def _offer(self, n_txs: int, submit_burst: int = 64) -> None:
        """Offer `n_txs` payment txs this round, cranking between bursts
        so flush timers and collects interleave with arrivals (paced
        submission, not one monolithic dump)."""
        offered = 0
        while offered < n_txs:
            burst = min(submit_burst, n_txs - offered)
            for _ in range(burst):
                i = self.rng.randrange(self.pool.n)
                j = self.rng.randrange(self.pool.n)
                if self.rng.random() < self.soroban_mix:
                    frame = self._soroban_frame(i)
                    self.soroban_offered += 1
                else:
                    frame = self._payment_frame(i, j)
                res = self.admission.submit(frame)
                self.statuses[res.code] = self.statuses.get(res.code, 0) + 1
            offered += burst
            was = self.admission.backpressured
            self.clock.crank()
            if self.admission.backpressured and not was:
                self.backpressure_engaged += 1
            self.peak_admission_depth = max(self.peak_admission_depth,
                                            self.admission.depth)
            self.peak_queue_depth = max(self.peak_queue_depth,
                                        self.tx_queue.size)

    def run(self, n_ledgers: int, offered_per_ledger: int) -> dict:
        """Run `n_ledgers` close rounds at `offered_per_ledger` offered
        txs each; returns the campaign report.

        The admission latency/batch-size percentiles are reset at run
        start so the report describes THIS run — the registry is
        process-global and would otherwise aggregate every earlier
        run/pipeline in the process (e.g. bench's floor measurement)."""
        from ..util.metrics import registry
        registry().timer("herder.admission.latency").reset()
        registry().histogram("herder.admission.batch-size").reset()
        t0 = _time.perf_counter()
        applied = 0
        for _ in range(n_ledgers):
            self._offer(offered_per_ledger)
            self.admission.drain()
            frames = self.tx_queue.tx_set_frames()
            self.clock.crank_for(self.lg.close_target)
            self.mgr.close_ledger(frames, self.lg._next_close_time())
            applied += len(frames)
            self.tx_queue.remove_applied(frames)
            self.tx_queue.shift()
        wall = _time.perf_counter() - t0
        lat = registry().snapshot(prefix="herder.admission.").get(
            "herder.admission.latency", {})
        bsz = registry().snapshot(prefix="herder.admission.").get(
            "herder.admission.batch-size", {})
        report = {
            "accounts": self.pool.n,
            "accounts_touched": self.pool.touched,
            "ledgers": n_ledgers,
            "offered": n_ledgers * offered_per_ledger,
            "applied": applied,
            "soroban_offered": self.soroban_offered,
            "wall_s": round(wall, 2),
            "sustained_tps": round(applied / wall, 1) if wall else 0.0,
            "statuses": dict(self.statuses),
            "peak_queue_depth": self.peak_queue_depth,
            "peak_admission_depth": self.peak_admission_depth,
            "backpressure_engaged": self.backpressure_engaged,
            "admission_stats": {
                k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in self.admission.stats.items()},
        }
        for q in ("p50", "p90", "p99"):
            if f"{q}_s" in lat:
                report[f"admission_{q}_us"] = round(lat[f"{q}_s"] * 1e6, 1)
        if "count" in bsz:
            report["batches"] = bsz["count"]
            report["batch_size_p50"] = bsz.get("p50", 0.0)
            report["batch_size_p99"] = bsz.get("p99", 0.0)
            report["batch_size_max"] = bsz.get("max", 0.0)
        report["bucketlistdb"] = self.store is not None
        if self.store is not None:
            bl = self.mgr.bucket_list
            report["peak_decoded_entries"] = bl.peak_decoded_entries
            report["live_entries"] = self.mgr.root.entry_count()
        return report

    def close(self) -> None:
        self.admission.close()


def _soroban_pool_frame(nid: bytes, pool: SeedAccountPool, i: int,
                        value: int):
    """One InvokeHostFunction frame from pool account `i` against ITS
    OWN contract (contract id derived from the account index), writing
    one persistent CONTRACT_DATA key.  Distinct accounts therefore have
    disjoint write sets — the footprint scheduler can fan them out as
    separate clusters."""
    from ..soroban.storage import contract_data_key
    from ..testutils import contract_address, invoke_op, make_soroban_data

    c = contract_address(1 + (i % 250))
    key = X.SCVal.sym("v")
    dk = contract_data_key(c, key, X.ContractDataDurability.PERSISTENT)
    sd = make_soroban_data(read_write=[dk])
    op = invoke_op(c, "put", [key, X.SCVal.u64(value),
                              X.SCVal.sym("persistent")])
    return build_tx(nid, pool.secret(i), pool.next_seq(i), [op],
                    fee=1000 + sd.resourceFee, soroban_data=sd)


class SorobanMixCampaign:
    """Mixed classic+Soroban close campaign with serial-vs-parallel
    hash identity.

    The same seed-derived traffic (payments from a ``SeedAccountPool``
    interleaved with per-account contract invokes) is closed twice —
    once with the footprint scheduler disabled (serial apply) and once
    with it fanning disjoint write-set clusters across threads — and
    EVERY per-close bucket-list hash must match byte-for-byte.  Each
    ledger's Soroban phase draws ``soroban_per_ledger`` DISTINCT
    accounts, so its write sets are disjoint and the parallel side
    genuinely runs that many concurrent clusters."""

    def __init__(self, n_accounts: int = 8, classic_per_ledger: int = 3,
                 soroban_per_ledger: int = 5, seed: int = 11,
                 network_passphrase: str = "soroban mix campaign"):
        assert soroban_per_ledger <= n_accounts
        self.nid = sha256(network_passphrase.encode())
        self.n_accounts = n_accounts
        self.classic_per_ledger = classic_per_ledger
        self.soroban_per_ledger = soroban_per_ledger
        self.seed = seed

    def _run_side(self, n_ledgers: int, parallel: bool) -> dict:
        from ..soroban import cluster_footprints, is_soroban_frame

        pool = SeedAccountPool(self.n_accounts, seed=self.seed)
        mgr = LedgerManager(self.nid)
        mgr.start_new_ledger()
        mgr.soroban_parallel_apply = parallel
        lg = LoadGenerator(mgr, seed=self.seed)
        lg.install_account_pool(pool)
        rng = random.Random(self.seed * 7919)
        hashes: List[bytes] = []
        max_clusters = 0
        applied = 0
        t0 = _time.perf_counter()
        for ledger in range(n_ledgers):
            frames = []
            for _ in range(self.classic_per_ledger):
                i, j = rng.sample(range(pool.n), 2)
                frames.append(build_tx(
                    self.nid, pool.secret(i), pool.next_seq(i),
                    [native_payment_op(pool.account_id(j),
                                       100 + rng.randrange(10 ** 6))],
                    fee=100 + rng.randrange(200)))
            for i in rng.sample(range(pool.n), self.soroban_per_ledger):
                frames.append(_soroban_pool_frame(
                    self.nid, pool, i, rng.randrange(2 ** 32)))
            sb = [f for f in frames if is_soroban_frame(f)]
            max_clusters = max(max_clusters, len(cluster_footprints(sb)))
            lg._close(frames)
            applied += len(frames)
            hashes.append(bytes(mgr.lcl_header.bucketListHash))
        return {"hashes": hashes, "lcl": mgr.lcl_hash,
                "max_clusters": max_clusters, "applied": applied,
                "wall_s": _time.perf_counter() - t0}

    def run(self, n_ledgers: int = 50) -> dict:
        serial = self._run_side(n_ledgers, parallel=False)
        par = self._run_side(n_ledgers, parallel=True)
        assert serial["hashes"] == par["hashes"], \
            "footprint-parallel close diverged from serial apply"
        assert serial["lcl"] == par["lcl"]
        return {
            "ledgers": n_ledgers,
            "applied": serial["applied"],
            "max_disjoint_clusters": par["max_clusters"],
            "serial_wall_s": round(serial["wall_s"], 2),
            "parallel_wall_s": round(par["wall_s"], 2),
            "hashes_identical": True,
            "bucket_hashes": serial["hashes"],
        }
