"""TransactionQueue — pending transactions between submission and inclusion.

Reference: src/herder/TransactionQueue.{h,cpp} — tryAdd (checkValid gating,
one pending tx per source account, fee-bump replace-by-fee at >=10x), ban
list with ban depth, size limiting with lowest-fee eviction, removeApplied /
shift after ledger close; src/herder/TxSetUtils — surge pricing (sort by
fee-per-op, trim to the ledger's op limit).
"""

from __future__ import annotations

import heapq
from fractions import Fraction
from typing import Callable, Dict, List, Optional, Sequence, Set

from .. import xdr as X
from ..ledger.ledger_txn import LedgerTxn
from ..transactions.frame import TransactionFrame
from ..util import logging as slog
from ..util.metrics import registry as _registry
from ..util.racetrace import race_checked

log = slog.get("Herder")

# Reference: TransactionQueue.h
FEE_MULTIPLIER = 10          # replace-by-fee bump factor
BAN_DEPTH = 10               # ledgers a banned tx stays banned
QUEUE_SIZE_MULTIPLIER = 4    # pool size = multiplier * max ledger ops


class AddResult:
    # Reference: TransactionQueue::AddResult::Code
    STATUS_PENDING = "pending"
    STATUS_DUPLICATE = "duplicate"
    STATUS_ERROR = "error"
    STATUS_TRY_AGAIN_LATER = "try-again-later"
    STATUS_BANNED = "banned"
    STATUS_FILTERED = "filtered"

    def __init__(self, code: str, result=None):
        self.code = code
        self.result = result

    def __repr__(self):
        return f"AddResult({self.code})"


def fee_per_op(frame: TransactionFrame) -> Fraction:
    """Exact rational fee rate.  Consensus-adjacent ordering must not go
    through floats: the reference compares fee rates by int128
    cross-multiplication (TxSetUtils feeRate3WayCompare); Fraction gives the
    same exact ordering."""
    return Fraction(frame.fee_bid, max(frame.num_operations(), 1))


def surge_sort_key(frame: TransactionFrame):
    """Surge pricing order: highest fee-per-op first, tx hash as the
    deterministic tiebreak (reference: TxSetUtils — feeRate comparison)."""
    return (-fee_per_op(frame), frame.content_hash())


# Eviction order = exact REVERSE of the surge sort BY CONSTRUCTION: max()
# over the same key picks the lowest fee-per-op tx, largest content hash
# among equal rates — precisely the tx surge pricing would include last
# (a bare min-by-fee left equal-rate ties to dict insertion order).  One
# key function so the two orders can never drift apart.
eviction_key = surge_sort_key


def _heap_key(frame: TransactionFrame):
    """Min-heap key whose MINIMUM is the eviction victim: lowest
    fee-per-op first, LARGEST content hash among equal rates (the
    negated-int hash inverts the byte order) — element-for-element the
    reverse of `surge_sort_key`, so `heap[0]` is exactly what
    `max(..., key=eviction_key)` used to scan for."""
    return (fee_per_op(frame),
            -int.from_bytes(frame.content_hash(), "big"))


@race_checked
class TransactionQueue:
    def __init__(self, ledger_manager, pool_ledger_multiplier: int =
                 QUEUE_SIZE_MULTIPLIER):
        self.lm = ledger_manager
        self.pool_multiplier = pool_ledger_multiplier
        # Queue state is owned by the main crank loop: http_admin
        # marshals /tx onto it and the admission pipeline runs as clock
        # actions, so mutation is single-threaded BY DESIGN; admin-thread
        # gauge reads (depth/banned) are GIL-atomic len() snapshots.  The
        # owned-by attestation is what the thread-safety lint checks, and
        # the race sanitizer proves it at runtime in `make race`.
        # source account id bytes -> frame (ONE pending tx per account)
        self.by_account: Dict[bytes, TransactionFrame] = {}  # corelint: owned-by=main -- mutated only on the crank loop; see class note
        self.by_hash: Dict[bytes, TransactionFrame] = {}  # corelint: owned-by=main -- mutated only on the crank loop; gauge reads are GIL-atomic
        # banned tx hash -> ledgers remaining
        self.banned: Dict[bytes, int] = {}  # corelint: owned-by=main -- mutated only on the crank loop; gauge reads are GIL-atomic
        # fee-ordered eviction index: a lazy-deletion
        # min-heap on `_heap_key` makes victim selection O(log n)
        # amortized instead of the old cached O(n) rescan per mutation —
        # under 2x overload every successful add evicts, so the rescan
        # was the sustained-TPS bottleneck.  Dropped frames stay in the
        # heap until they surface (identity-checked against by_hash) or
        # a compaction rebuilds it.  Entries carry a monotonic push
        # counter between key and frame: a banned-then-resubmitted
        # identical tx gives two entries with EQUAL (fee, hash) keys,
        # and without the counter heap sifts would fall through to
        # comparing TransactionFrames (TypeError).
        self._evict_heap: List[tuple] = []
        self._evict_seq = 0
        # depth gauges: registry is process-global, so the last-created
        # queue wins (multi-node simulations share one registry; per-node
        # depth stays in /metrics' herder section); weak_gauge so a
        # torn-down node's graph is not pinned
        _registry().weak_gauge("herder.tx-queue.depth", self,
                               lambda q: q.size)
        _registry().weak_gauge("herder.tx-queue.banned", self,
                               lambda q: len(q.banned))

    # ------------------------------------------------------------------
    def _account_key(self, frame: TransactionFrame) -> bytes:
        return frame.source_account_id().to_xdr()

    def _max_queue_size(self) -> int:
        return self.pool_multiplier * max(
            self.lm.lcl_header.maxTxSetSize, 1)

    def try_add(self, frame: TransactionFrame,
                close_time: Optional[int] = None) -> AddResult:
        """Validate and enqueue.  Reference: TransactionQueue::tryAdd."""
        h = frame.content_hash()
        if h in self.banned:
            return AddResult(AddResult.STATUS_BANNED)
        if h in self.by_hash:
            return AddResult(AddResult.STATUS_DUPLICATE)

        akey = self._account_key(frame)
        existing = self.by_account.get(akey)
        if existing is not None:
            # replace-by-fee: same account needs >= FEE_MULTIPLIER x fee
            # (full fee comparison; reference compares fee bids)
            if frame.fee_bid < FEE_MULTIPLIER * existing.fee_bid:
                return AddResult(AddResult.STATUS_TRY_AGAIN_LATER)

        ct = close_time if close_time is not None \
            else self.lm.lcl_header.scpValue.closeTime
        with LedgerTxn(self.lm.root) as ltx:  # read-only: rolls back on exit
            res = frame.check_valid(ltx, ct)
        if res.result.switch != X.TransactionResultCode.txSUCCESS:
            return AddResult(AddResult.STATUS_ERROR, res)

        if existing is not None:
            self._drop(existing)
        elif len(self.by_hash) >= self._max_queue_size():
            victim = self._eviction_victim()
            if fee_per_op(victim) >= fee_per_op(frame):
                return AddResult(AddResult.STATUS_TRY_AGAIN_LATER)
            self._drop(victim)
            self.banned[victim.content_hash()] = BAN_DEPTH

        self.by_account[akey] = frame
        self.by_hash[h] = frame
        self._heap_push(frame)
        return AddResult(AddResult.STATUS_PENDING)

    def _heap_push(self, frame: TransactionFrame) -> None:
        self._evict_seq += 1
        heapq.heappush(self._evict_heap,
                       (*_heap_key(frame), self._evict_seq, frame))

    def _eviction_victim(self) -> TransactionFrame:
        """The frame a full queue evicts first (see eviction_key) in
        O(log n) amortized: pop heap entries whose frame is no longer
        queued (lazy deletion — identity check, not just hash presence,
        so a re-added equal-bytes tx can never resurrect a stale entry),
        then peek.  Callers guarantee the queue is non-empty."""
        heap = self._evict_heap
        while heap:
            frame = heap[0][3]
            if self.by_hash.get(frame.content_hash()) is frame:
                return frame
            heapq.heappop(heap)
        # unreachable when by_hash is non-empty and every add pushed;
        # rebuild defensively rather than corrupt eviction economics
        self._rebuild_heap()
        return self._evict_heap[0][3]

    def _rebuild_heap(self) -> None:
        self._evict_heap = []
        for f in self.by_hash.values():
            self._heap_push(f)

    def _drop(self, frame: TransactionFrame) -> None:
        self.by_hash.pop(frame.content_hash(), None)
        akey = self._account_key(frame)
        if self.by_account.get(akey) is frame:
            del self.by_account[akey]
        # lazy heap deletion, bounded: when stale entries dominate the
        # live set, compact so heap memory stays O(queue)
        if len(self._evict_heap) > 64 \
                and len(self._evict_heap) > 2 * len(self.by_hash):
            self._rebuild_heap()

    # ------------------------------------------------------------------
    def remove_applied(self, frames: Sequence[TransactionFrame]) -> None:
        """Drop txs included in the last closed ledger.
        Reference: TransactionQueue::removeApplied."""
        for f in frames:
            got = self.by_hash.get(f.content_hash())
            if got is not None:
                self._drop(got)
            else:
                # a different tx from the same account was applied: ours is
                # now stale (bad seq) — drop it too
                mine = self.by_account.get(self._account_key(f))
                if mine is not None and mine.seq_num <= f.seq_num:
                    self._drop(mine)

    def ban(self, frames: Sequence[TransactionFrame]) -> None:
        for f in frames:
            self.banned[f.content_hash()] = BAN_DEPTH
            got = self.by_hash.get(f.content_hash())
            if got is not None:
                self._drop(got)

    def shift(self) -> None:
        """Age the ban list one ledger.  Reference: TransactionQueue::shift."""
        for h in list(self.banned):
            self.banned[h] -= 1
            if self.banned[h] <= 0:
                del self.banned[h]

    def is_banned(self, tx_hash: bytes) -> bool:
        return tx_hash in self.banned

    def below_fee_floor(self, frame: TransactionFrame) -> bool:
        """True when a FULL queue would refuse this tx on fee grounds
        alone: it does not beat the current eviction victim's fee rate
        (and is not a replace-by-fee candidate for its own account's
        pending tx).  The admission pipeline applies this surge-pricing
        economics check BEFORE spending signature verification on a tx
        that try_add would reject anyway."""
        if len(self.by_hash) < self._max_queue_size():
            return False
        if self._account_key(frame) in self.by_account:
            return False  # replace-by-fee path decides, not eviction
        return fee_per_op(self._eviction_victim()) >= fee_per_op(frame)

    # ------------------------------------------------------------------
    def get_transactions(self) -> List[TransactionFrame]:
        return list(self.by_hash.values())  # corelint: disable=iteration-order -- arrival-order inspection snapshot; canonical order is tx_set_frames()

    def tx_set_frames(self, max_ops: Optional[int] = None
                      ) -> List[TransactionFrame]:
        """Candidate tx set under surge pricing: best fee-per-op first,
        trimmed to the ledger operation limit.  Reference:
        TxSetUtils/TxSetFrame — surge pricing + trimInvalid.

        Soroban txs ride a separate lane (reference: SurgePricingLaneConfig
        with a dedicated Soroban lane): they are capped by the network
        config's per-ledger tx count and declared-instruction total, and do
        NOT consume classic tx-set operations."""
        from ..soroban import is_soroban_frame, network_config
        header = self.lm.lcl_header
        limit = max_ops if max_ops is not None else header.maxTxSetSize
        # protocol >= 11 counts operations; earlier protocols count txs
        count_ops = header.ledgerVersion >= 11
        net = network_config()
        out: List[TransactionFrame] = []
        used = 0
        sb_count = 0
        sb_insns = 0
        for f in sorted(self.by_hash.values(), key=surge_sort_key):
            if is_soroban_frame(f):
                sd = f.soroban_data()
                insns = int(sd.resources.instructions) if sd is not None else 0
                if sb_count + 1 > net.ledger_max_tx_count or \
                        sb_insns + insns > net.ledger_max_instructions:
                    continue
                out.append(f)
                sb_count += 1
                sb_insns += insns
                continue
            cost = f.num_operations() if count_ops else 1
            if used + cost > limit:
                continue
            out.append(f)
            used += cost
        return out

    @property
    def size(self) -> int:
        return len(self.by_hash)
