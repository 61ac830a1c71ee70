"""Ballot protocol: PREPARE → CONFIRM → EXTERNALIZE via federated voting.

Reference: src/scp/BallotProtocol.{h,cpp} — processEnvelope, bumpState,
attemptAcceptPrepared/ConfirmPrepared/AcceptCommit/ConfirmCommit, attemptBump,
checkHeardFromQuorum, emitCurrentStateStatement.  Ballots are (counter, value)
tuples internally; SCPBallot at the XDR boundary.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..xdr import scp as SX
from . import quorum as Q
from .driver import BALLOT_PROTOCOL_TIMER, ValidationLevel

StType = SX.SCPStatementType
INT32_MAX = 2**31 - 1

Ballot = Tuple[int, bytes]  # (counter, value)

PHASE_PREPARE = 0
PHASE_CONFIRM = 1
PHASE_EXTERNALIZE = 2


def _b(xb) -> Ballot:
    return (xb.counter, xb.value)


def _xb(b: Ballot):
    return SX.SCPBallot(counter=b[0], value=b[1])


def compatible(a: Ballot, b: Ballot) -> bool:
    return a[1] == b[1]


def less_and_compatible(a: Ballot, b: Ballot) -> bool:
    return a <= b and compatible(a, b)


def less_and_incompatible(a: Ballot, b: Ballot) -> bool:
    return a <= b and not compatible(a, b)


class BallotProtocol:
    def __init__(self, slot):
        self.slot = slot
        self.phase = PHASE_PREPARE
        self.b: Optional[Ballot] = None       # current ballot
        self.p: Optional[Ballot] = None       # highest accepted prepared
        self.pp: Optional[Ballot] = None      # p' (incompatible with p)
        self.h: Optional[Ballot] = None       # highest confirmed prepared
        self.c: Optional[Ballot] = None       # lowest commit
        self.z: Optional[bytes] = None        # value override
        self.latest_envelopes: Dict[bytes, object] = {}
        self.last_envelope = None
        self.heard_from_quorum = False
        self._advancing = 0
        self.timer_armed_counter = -1
        # incremental per-slot quorum state (reference: Slot's cached
        # mHeardFromQuorum edge): per-node counters + compiled qsets +
        # epoch-keyed verdict memo, maintained in process_envelope
        self.index = Q.StatementIndex()
        # node -> compiled statement summary (see _summarize), kept in
        # lockstep with latest_envelopes
        self._summaries: Dict[bytes, tuple] = {}

    # ------------------------------------------------------------------
    # statement summaries + predicates
    #
    # Every federated-voting predicate runs per NODE per quorum question —
    # the inner loop of the whole protocol.  Evaluating them against raw
    # XDR statements pays the lazy-decode descriptor machinery on every
    # field access (measured: ~25% of a 51-node campaign inside codec
    # __get__/arm), so each statement is compiled ONCE at intake into a
    # plain tuple and the predicates read tuples:
    #
    #   PREPARE:     (0, ballot, prepared|None, preparedPrime|None, nC, nH)
    #   CONFIRM:     (1, ballot, nPrepared, nCommit, nH)
    #   EXTERNALIZE: (2, commit, nH)
    #
    # where ballot/commit are (counter, value) tuples.  Same move as
    # compile_qset for quorum slices (scp/quorum.py).
    # ------------------------------------------------------------------
    @staticmethod
    def _summarize(st) -> tuple:
        pl = st.pledges
        if pl.type == StType.SCP_ST_PREPARE:
            pr = pl.prepare
            return (0, _b(pr.ballot),
                    _b(pr.prepared) if pr.prepared is not None else None,
                    _b(pr.preparedPrime) if pr.preparedPrime is not None
                    else None, pr.nC, pr.nH)
        if pl.type == StType.SCP_ST_CONFIRM:
            co = pl.confirm
            return (1, _b(co.ballot), co.nPrepared, co.nCommit, co.nH)
        ex = pl.externalize
        return (2, _b(ex.commit), ex.nH)

    @staticmethod
    def _counter_of(ss: tuple) -> int:
        return ss[1][0] if ss[0] != 2 else INT32_MAX

    @staticmethod
    def _votes_prepare(cand: Ballot, ss: tuple) -> bool:
        if ss[0] == 0:
            return less_and_compatible(cand, ss[1])
        return compatible(cand, ss[1])   # CONFIRM ballot / EXTERNALIZE commit

    @staticmethod
    def _accepts_prepared(cand: Ballot, ss: tuple) -> bool:
        k = ss[0]
        if k == 0:
            p, pp = ss[2], ss[3]
            return ((p is not None and less_and_compatible(cand, p)) or
                    (pp is not None and less_and_compatible(cand, pp)))
        if k == 1:
            return less_and_compatible(cand, (ss[2], ss[1][1]))
        return compatible(cand, ss[1])

    @staticmethod
    def _votes_commit(value: bytes, n: int, ss: tuple) -> bool:
        k = ss[0]
        if k == 0:
            return ss[4] != 0 and ss[1][1] == value and ss[4] <= n <= ss[5]
        if k == 1:
            return ss[1][1] == value and ss[3] <= n
        return ss[1][1] == value and ss[1][0] <= n

    @staticmethod
    def _accepts_commit(value: bytes, n: int, ss: tuple) -> bool:
        k = ss[0]
        if k == 0:
            return False
        if k == 1:
            return ss[1][1] == value and ss[3] <= n <= ss[4]
        return ss[1][1] == value and ss[1][0] <= n

    @staticmethod
    def _prepare_candidates(hint) -> List[Ballot]:
        pl = hint.pledges
        out: Set[Ballot] = set()
        if pl.type == StType.SCP_ST_PREPARE:
            out.add(_b(pl.prepare.ballot))
            if pl.prepare.prepared is not None:
                out.add(_b(pl.prepare.prepared))
            if pl.prepare.preparedPrime is not None:
                out.add(_b(pl.prepare.preparedPrime))
        elif pl.type == StType.SCP_ST_CONFIRM:
            v = pl.confirm.ballot.value
            out.add((pl.confirm.nPrepared, v))
            out.add((INT32_MAX, v))
        else:
            out.add((INT32_MAX, pl.externalize.commit.value))
        return sorted(out, reverse=True)

    def _st_order(self, st):
        pl = st.pledges
        if pl.type == StType.SCP_ST_PREPARE:
            pr = pl.prepare
            return (0, _b(pr.ballot),
                    _b(pr.prepared) if pr.prepared is not None else (0, b""),
                    _b(pr.preparedPrime) if pr.preparedPrime is not None
                    else (0, b""), pr.nH)
        if pl.type == StType.SCP_ST_CONFIRM:
            co = pl.confirm
            return (1, _b(co.ballot), co.nPrepared, co.nCommit, co.nH)
        return (2, (INT32_MAX, b""), 0, 0, 0)

    def _is_newer(self, st, old) -> bool:
        return self._st_order(st) > self._st_order(old)

    @staticmethod
    def _sane(st, self_st: bool = False) -> bool:
        """Reference: BallotProtocol::isStatementSane.  A self statement may
        carry ballot counter 0 (never emitted; see _emit_current_state)."""
        pl = st.pledges
        if pl.type == StType.SCP_ST_PREPARE:
            pr = pl.prepare
            if not self_st and pr.ballot.counter == 0:
                return False
            if pr.prepared is not None and pr.preparedPrime is not None:
                # p' < p and incompatible
                if not (_b(pr.preparedPrime) < _b(pr.prepared)
                        and not compatible(_b(pr.preparedPrime),
                                           _b(pr.prepared))):
                    return False
            if pr.nH != 0 and (pr.prepared is None
                               or pr.nH > pr.prepared.counter):
                return False
            if pr.nC != 0 and not (pr.nH != 0
                                   and pr.ballot.counter >= pr.nH >= pr.nC):
                return False
            return True
        if pl.type == StType.SCP_ST_CONFIRM:
            co = pl.confirm
            return (co.ballot.counter > 0
                    and co.nCommit <= co.nH <= co.ballot.counter)
        ex = pl.externalize
        return 0 < ex.commit.counter <= ex.nH

    # ------------------------------------------------------------------
    # state mutation helpers
    # ------------------------------------------------------------------
    def _stmt_map(self) -> Dict[bytes, tuple]:
        """node -> compiled statement summary (the map every federated
        predicate runs over); maintained incrementally, never rebuilt."""
        return self._summaries

    def _bump_to_ballot(self, ballot: Ballot, require_ge: bool) -> None:
        got_bumped = self.b is None or self.b[0] != ballot[0]
        if self.b is None:
            self.slot.driver.started_ballot_protocol(self.slot.slot_index,
                                                     _xb(ballot))
        self.b = ballot
        if got_bumped:
            self.heard_from_quorum = False

    def _update_current_if_needed(self, h: Ballot) -> bool:
        if self.b is None or self.b < h:
            self._bump_to_ballot(h, True)
            return True
        return False

    def _set_prepared(self, ballot: Ballot) -> bool:
        did = False
        if self.p is None:
            self.p = ballot
            did = True
        elif self.p < ballot:
            if not compatible(self.p, ballot):
                self.pp = self.p
            self.p = ballot
            did = True
        elif ballot < self.p and not compatible(ballot, self.p):
            if self.pp is None or self.pp < ballot:
                self.pp = ballot
                did = True
        return did

    # ------------------------------------------------------------------
    # protocol steps (reference: BallotProtocol::attempt*)
    # ------------------------------------------------------------------
    def _attempt_accept_prepared(self, hint) -> bool:
        if self.phase not in (PHASE_PREPARE, PHASE_CONFIRM):
            return False
        ln, stmt_map = self.slot.local_node, self._stmt_map()
        qset_of = self.slot.qset_of_statement
        for cand in self._prepare_candidates(hint):
            if self.phase == PHASE_CONFIRM:
                if not (self.p is not None
                        and less_and_compatible(self.p, cand)):
                    continue
            # nothing new?
            if ((self.p is not None and less_and_compatible(cand, self.p)) or
                    (self.pp is not None
                     and less_and_compatible(cand, self.pp))):
                continue
            if ln.federated_accept(
                    lambda st, c=cand: self._votes_prepare(c, st),
                    lambda st, c=cand: self._accepts_prepared(c, st),
                    stmt_map, qset_of,
                    index=self.index, key=("acc-prep", cand)):
                return self._set_accept_prepared(cand)
        return False

    def _set_accept_prepared(self, ballot: Ballot) -> bool:
        did = self._set_prepared(ballot)
        # accepting prepared(p) with p > c incompatible aborts commit c
        if self.c is not None and self.h is not None:
            if ((self.p is not None
                 and less_and_incompatible(self.h, self.p)) or
                    (self.pp is not None
                     and less_and_incompatible(self.h, self.pp))):
                self.c = None
                did = True
        if did:
            self.slot.driver.accepted_ballot_prepared(self.slot.slot_index,
                                                      _xb(ballot))
            self._emit_current_state()
        return did

    def _attempt_confirm_prepared(self, hint) -> bool:
        if self.phase != PHASE_PREPARE or self.p is None:
            return False
        ln, stmt_map = self.slot.local_node, self._stmt_map()
        qset_of = self.slot.qset_of_statement
        candidates = self._prepare_candidates(hint)
        new_h = None
        for cand in candidates:
            if self.h is not None and cand <= self.h:
                break
            if ln.federated_ratify(
                    lambda st, c=cand: self._accepts_prepared(c, st),
                    stmt_map, qset_of,
                    index=self.index, key=("rat-prep", cand)):
                new_h = cand
                break
        if new_h is None:
            return False
        new_c = None
        if (self.c is None
                and not (self.p is not None
                         and less_and_incompatible(new_h, self.p))
                and not (self.pp is not None
                         and less_and_incompatible(new_h, self.pp))):
            for cand in sorted(candidates):
                if self.b is not None and cand < self.b:
                    continue
                if not less_and_compatible(cand, new_h):
                    continue
                if ln.federated_ratify(
                        lambda st, c=cand: self._accepts_prepared(c, st),
                        stmt_map, qset_of,
                        index=self.index, key=("rat-prep", cand)):
                    new_c = cand
                    break
        self.z = new_h[1]
        if self.h is None or self.h < new_h:
            self.h = new_h
        if new_c is not None:
            self.c = new_c
        self._update_current_if_needed(self.h)
        self.slot.driver.confirmed_ballot_prepared(self.slot.slot_index,
                                                   _xb(new_h))
        self._emit_current_state()
        return True

    def _commit_boundaries(self, value: bytes) -> List[int]:
        out: Set[int] = set()
        for ss in self._summaries.values():
            k = ss[0]
            if k == 0:
                if ss[1][1] == value and ss[4] != 0:
                    out.update((ss[4], ss[5]))
            elif k == 1:
                if ss[1][1] == value:
                    out.update((ss[3], ss[4]))
            else:
                if ss[1][1] == value:
                    out.update((ss[1][0], ss[2]))
        return sorted(out, reverse=True)

    @staticmethod
    def _find_extended_interval(boundaries: List[int], pred) -> Tuple[int, int]:
        """Largest [lo, hi] (by hi, extended down) where pred holds.
        Reference: BallotProtocol::findExtendedInterval."""
        cur = (0, 0)
        for b in boundaries:  # descending
            cand = (b, b) if cur == (0, 0) else (b, cur[1])
            if pred(cand):
                cur = cand
            elif cur != (0, 0):
                break
        return cur

    def _attempt_accept_commit(self, hint) -> bool:
        if self.phase not in (PHASE_PREPARE, PHASE_CONFIRM):
            return False
        pl = hint.pledges
        if pl.type == StType.SCP_ST_PREPARE:
            if pl.prepare.nC == 0:
                return False
            ballot = (pl.prepare.nH, pl.prepare.ballot.value)
        elif pl.type == StType.SCP_ST_CONFIRM:
            ballot = (pl.confirm.nH, pl.confirm.ballot.value)
        else:
            ballot = (pl.externalize.nH, pl.externalize.commit.value)
        if self.phase == PHASE_CONFIRM:
            if not compatible(ballot, self.h):
                return False
        ln, stmt_map = self.slot.local_node, self._stmt_map()
        qset_of = self.slot.qset_of_statement
        value = ballot[1]

        def pred(interval):
            lo, hi = interval
            return ln.federated_accept(
                lambda st: self._votes_commit(value, lo, st)
                and self._votes_commit(value, hi, st),
                lambda st: self._accepts_commit(value, lo, st)
                and self._accepts_commit(value, hi, st),
                stmt_map, qset_of,
                index=self.index, key=("acc-commit", value, lo, hi))

        lo, hi = self._find_extended_interval(self._commit_boundaries(value),
                                              pred)
        if lo == 0:
            return False
        if self.phase == PHASE_CONFIRM and hi <= self.h[0] and self.c is not None:
            return False
        return self._set_accept_commit((lo, value), (hi, value))

    def _set_accept_commit(self, c: Ballot, h: Ballot) -> bool:
        did = False
        self.z = h[1]
        if self.h != h or self.c != c:
            self.c, self.h = c, h
            did = True
        if self.phase == PHASE_PREPARE:
            self.phase = PHASE_CONFIRM
            if self.b is not None and not less_and_compatible(h, self.b):
                self._bump_to_ballot(h, False)
            # accepting commit(c..h) implies prepared(h): keep the CONFIRM-
            # phase invariant that p is set (the CONFIRM statement carries
            # nPrepared)
            self._set_prepared(h)
            self.pp = None
            did = True
        if did:
            self._update_current_if_needed(self.h)
            self.slot.driver.accepted_commit(self.slot.slot_index, _xb(h))
            self._emit_current_state()
        return did

    def _attempt_confirm_commit(self, hint) -> bool:
        if self.phase != PHASE_CONFIRM or self.h is None or self.c is None:
            return False
        pl = hint.pledges
        if pl.type == StType.SCP_ST_PREPARE:
            return False
        elif pl.type == StType.SCP_ST_CONFIRM:
            ballot = (pl.confirm.nH, pl.confirm.ballot.value)
        else:
            ballot = (pl.externalize.nH, pl.externalize.commit.value)
        if not compatible(ballot, self.c):
            return False
        ln, stmt_map = self.slot.local_node, self._stmt_map()
        qset_of = self.slot.qset_of_statement
        value = ballot[1]

        def pred(interval):
            lo, hi = interval
            return ln.federated_ratify(
                lambda st: self._votes_commit(value, lo, st)
                and self._votes_commit(value, hi, st),
                stmt_map, qset_of,
                index=self.index, key=("rat-commit", value, lo, hi))

        lo, hi = self._find_extended_interval(self._commit_boundaries(value),
                                              pred)
        if lo == 0:
            return False
        return self._set_confirm_commit((lo, value), (hi, value))

    def _set_confirm_commit(self, c: Ballot, h: Ballot) -> bool:
        self.c, self.h = c, h
        self._update_current_if_needed(self.h)
        self.phase = PHASE_EXTERNALIZE
        self._emit_current_state()
        self.slot.stop_nomination()
        self.slot.driver.value_externalized(self.slot.slot_index, c[1])
        return True

    def _attempt_bump(self) -> bool:
        """Counter catch-up: if a v-blocking set is ahead of our counter,
        jump to the lowest counter that is still v-blocking-ahead."""
        if self.phase not in (PHASE_PREPARE, PHASE_CONFIRM):
            return False
        ln = self.slot.local_node
        target = self.b[0] if self.b is not None else 0
        counters = self.index.node_counter   # read-only view, no rebuild
        ahead = sorted({c for c in counters.values() if c > target})
        # v-blocking-ness is monotone in the node set, so only the smallest
        # ahead counter (largest node set) can qualify; the verdict runs
        # over compiled qsets and LATCHES through the StatementIndex
        # (counters only grow — a regression drops the latches)
        for n in ahead:
            if Q.v_blocking_ahead(ln.qset, ln.qset_hash, self.index, n):
                # abandon_ballot owns the value selection (z, then the
                # nomination composite, then the current ballot's value)
                return self.abandon_ballot(n)
            break
        return False

    def _check_heard_from_quorum(self) -> None:
        if self.b is None:
            return
        ln = self.slot.local_node
        heard = Q.heard_from_quorum(ln.qset, ln.qset_hash, self.index,
                                    self.b[0])
        if heard:
            was = self.heard_from_quorum
            self.heard_from_quorum = True
            if not was:
                self.slot.driver.ballot_did_hear_from_quorum(
                    self.slot.slot_index, _xb(self.b))
            if (self.phase != PHASE_EXTERNALIZE
                    and self.timer_armed_counter != self.b[0]):
                counter = self.b[0]
                self.timer_armed_counter = counter
                self.slot.driver.setup_timer(
                    self.slot.slot_index, BALLOT_PROTOCOL_TIMER,
                    self.slot.driver.compute_timeout(counter),
                    lambda: self._on_timeout(counter))
        else:
            self.heard_from_quorum = False

    def _on_timeout(self, counter: int) -> None:
        """Ballot timer expiry → abandon the current ballot counter."""
        self.timer_armed_counter = -1
        if self.phase == PHASE_EXTERNALIZE:
            return
        if self.b is not None and self.b[0] != counter:
            return
        self.abandon_ballot(0)

    def abandon_ballot(self, n: int) -> bool:
        value = self.z
        if value is None:
            comp = self.slot.nomination.latest_composite
            if comp is not None:
                value = comp
            elif self.b is not None:
                value = self.b[1]
        if value is None:
            return False
        if n == 0:
            return self.bump_state(value, force=True)
        return self._bump_state(value, n)

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------
    def bump_state(self, value: bytes, force: bool) -> bool:
        if not force and self.b is not None:
            return False
        n = (self.b[0] + 1) if self.b is not None else 1
        return self._bump_state(value, n)

    def _bump_state(self, value: bytes, n: int) -> bool:
        if self.phase not in (PHASE_PREPARE, PHASE_CONFIRM):
            return False
        new_b = (n, self.z if self.z is not None else value)
        if not self._update_current_value(new_b):
            return False
        self._emit_current_state()
        self._check_heard_from_quorum()
        return True

    def _update_current_value(self, ballot: Ballot) -> bool:
        if self.phase not in (PHASE_PREPARE, PHASE_CONFIRM):
            return False
        if self.phase == PHASE_CONFIRM and not compatible(ballot, self.h):
            return False
        if self.b is None or self.b < ballot:
            self._bump_to_ballot(ballot, True)
            return True
        return False

    def process_envelope(self, env, self_env: bool = False) -> bool:
        st = env.statement
        nid = st.nodeID.value
        if not self._sane(st, self_st=self_env):
            return False
        if not self._validate_values(st):
            return False
        old = self.latest_envelopes.get(nid)
        if old is not None and not self._is_newer(st, old.statement):
            return False
        self.latest_envelopes[nid] = env
        ss = self._summarize(st)
        self._summaries[nid] = ss
        self.index.note_statement(nid, self._counter_of(ss),
                                  self.slot.qset_of_statement(st),
                                  Q.statement_qset_hash(st))
        self._advance_slot(st, from_self=self_env)
        return True

    def _validate_values(self, st) -> bool:
        pl = st.pledges
        values = []
        if pl.type == StType.SCP_ST_PREPARE:
            if pl.prepare.ballot.counter:
                values.append(pl.prepare.ballot.value)
            if pl.prepare.prepared is not None:
                values.append(pl.prepare.prepared.value)
        elif pl.type == StType.SCP_ST_CONFIRM:
            values.append(pl.confirm.ballot.value)
        else:
            values.append(pl.externalize.commit.value)
        for v in values:
            lvl = self.slot.driver.validate_value(self.slot.slot_index, v,
                                                  nomination=False)
            if lvl == ValidationLevel.INVALID:
                return False
        return True

    def _advance_slot(self, hint, from_self: bool = False) -> None:
        self._advancing += 1
        try:
            if self._advancing > 10:  # reference: mCurrentMessageLevel cap
                return
            did = False
            did |= self._attempt_accept_prepared(hint)
            did |= self._attempt_confirm_prepared(hint)
            did |= self._attempt_accept_commit(hint)
            did |= self._attempt_confirm_commit(hint)
            if self._advancing == 1:
                while self._attempt_bump():
                    did = True
                self._check_heard_from_quorum()
        finally:
            self._advancing -= 1

    # ------------------------------------------------------------------
    # statement emission
    # ------------------------------------------------------------------
    def _build_statement(self):
        ln = self.slot.local_node
        if self.phase == PHASE_PREPARE:
            pledges = SX.SCPStatementPledges.prepare(SX.SCPPrepare(
                quorumSetHash=ln.qset_hash,
                ballot=_xb(self.b),
                prepared=_xb(self.p) if self.p is not None else None,
                preparedPrime=_xb(self.pp) if self.pp is not None else None,
                nC=self.c[0] if self.c is not None else 0,
                nH=min(self.h[0], self.b[0]) if self.h is not None else 0))
        elif self.phase == PHASE_CONFIRM:
            pledges = SX.SCPStatementPledges.confirm(SX.SCPConfirm(
                ballot=_xb(self.b),
                nPrepared=self.p[0],
                nCommit=self.c[0],
                nH=self.h[0],
                quorumSetHash=ln.qset_hash))
        else:
            pledges = SX.SCPStatementPledges.externalize(SX.SCPExternalize(
                commit=_xb(self.c),
                nH=self.h[0],
                commitQuorumSetHash=ln.qset_hash))
        return SX.SCPStatement(nodeID=self.slot.local_node_xdr_id(),
                               slotIndex=self.slot.slot_index,
                               pledges=pledges)

    def _emit_current_state(self) -> None:
        if self.b is None:
            return
        st = self._build_statement()
        env = self.slot.create_envelope(st)
        if not self.process_envelope(env, self_env=True):
            # Rejection for "not newer than our previous statement" is
            # benign (don't re-emit); rejection for sanity/validation means
            # protocol state corruption.  Reference: emitCurrentStateStatement
            # throws "moved to a bad state (ballot protocol)".
            if not (self._sane(st, self_st=True)
                    and self._validate_values(st)):
                raise RuntimeError("moved to a bad state (ballot protocol)")
            return
        if (self.last_envelope is None
                or self._is_newer(st, self.last_envelope.statement)):
            self.last_envelope = env
            if self.slot.fully_validated:
                self.slot.driver.emit_envelope(env)

    def get_latest_message(self, node_id: bytes):
        return self.latest_envelopes.get(node_id)

    def current_state(self) -> List:
        return [self.last_envelope] if self.last_envelope else []

    def externalized_value(self) -> Optional[bytes]:
        if self.phase == PHASE_EXTERNALIZE:
            return self.c[1]
        return None
