"""Nomination protocol: weighted-leader value proposal + federated voting to
confirm nomination candidates.

Reference: src/scp/NominationProtocol.{h,cpp} — processEnvelope, nominate,
updateRoundLeaders, getNewValueFromNomination.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..xdr import scp as SX
from . import quorum as Q
from .driver import NOMINATION_TIMER, ValidationLevel

StType = SX.SCPStatementType


def _newer_by_summary(votes_f: frozenset, accepted_f: frozenset,
                      new_total: int, old_summary: tuple,
                      old_total: int) -> bool:
    """Registry form of _is_newer: the old statement's frozensets come
    from the per-node summary map instead of a fresh XDR walk + set()
    build per envelope.  Growth is measured on the RAW vote-list lengths
    (a hostile statement may carry duplicates; collapsing them here would
    change which replays get rejected)."""
    old_votes_f, old_accepted_f = old_summary
    if not (old_votes_f <= votes_f and old_accepted_f <= accepted_f):
        return False
    return new_total > old_total


class NominationProtocol:
    def __init__(self, slot):
        self.slot = slot
        self.round_number = 0
        self.votes: Set[bytes] = set()
        self.accepted: Set[bytes] = set()
        self.candidates: Set[bytes] = set()
        self.latest_nominations: Dict[bytes, object] = {}  # node -> envelope
        # node -> (votes frozenset, accepted frozenset), in lockstep with
        # latest_nominations
        self._summaries: Dict[bytes, tuple] = {}
        # node -> len(votes) + len(accepted) of the RAW lists (the
        # _is_newer growth measure; kept separately so the summary tuple
        # shape stays (votes, accepted) for every existing consumer)
        self._summary_sizes: Dict[bytes, int] = {}
        # per-value voter registries, updated with each statement's DELTA
        # (sound because _is_newer guarantees vote sets only grow): the
        # federated accept/ratify calls below take these materialized
        # sets instead of sweeping every statement per value per envelope
        self._voted_nom: Dict[bytes, set] = {}      # value -> voters
        self._accepted_nom: Dict[bytes, set] = {}   # value -> accepters
        # incremental per-slot quorum state over the nomination statement
        # map; nomination vote sets only ever grow (_is_newer), so
        # accept/ratify verdicts LATCH per value (quorum.StatementIndex)
        self.index = Q.StatementIndex()
        self.last_envelope = None            # last nomination we emitted
        self.round_leaders: Set[bytes] = set()
        self.nomination_started = False
        self.latest_composite: Optional[bytes] = None
        self.previous_value = b""
        # leader-candidate set cache: normalize_qset + qset_nodes build
        # fresh XDR trees per round otherwise (keyed by local qset hash
        # so a mid-slot qset change recomputes)
        self._cand_qset_hash: Optional[bytes] = None
        self._leader_candidates: Set[bytes] = set()

    # --- statement access -------------------------------------------------
    def _stmt_map(self) -> Dict[bytes, tuple]:
        """node -> (votes frozenset, accepted frozenset) summary — the
        map the federated predicates run over.  Compiled once per
        statement at intake (set membership instead of XDR list scans —
        same move as ballot.py's statement summaries) and maintained
        incrementally."""
        return self._summaries

    @staticmethod
    def _nom(st):
        return st.pledges.nominate

    def _is_newer(self, st, old_st) -> bool:
        """Old statement is subsumed if votes+accepted grew."""
        a, b = self._nom(old_st), self._nom(st)
        if not (set(a.votes) <= set(b.votes)):
            return False
        if not (set(a.accepted) <= set(b.accepted)):
            return False
        return (len(b.votes) + len(b.accepted)
                > len(a.votes) + len(a.accepted))

    @staticmethod
    def _sane(st) -> bool:
        nom = st.pledges.nominate
        return (len(nom.votes) + len(nom.accepted)) > 0

    # --- leader election --------------------------------------------------
    def _node_priority(self, node_id: bytes) -> int:
        d, ln = self.slot.driver, self.slot.local_node
        w = (ln.node_weight(node_id) if node_id != ln.node_id
             else (1 << 64) - 1)  # local node always max weight (reference)
        if d.compute_hash_node(self.slot.slot_index, self.previous_value,
                               False, self.round_number, node_id) < w:
            return d.compute_hash_node(self.slot.slot_index,
                                       self.previous_value, True,
                                       self.round_number, node_id)
        return 0

    def update_round_leaders(self) -> None:
        ln = self.slot.local_node
        if self._cand_qset_hash != ln.qset_hash:
            qset = Q.normalize_qset(ln.qset, remove=ln.node_id)
            self._leader_candidates = {ln.node_id} | Q.qset_nodes(qset)
            self._cand_qset_hash = ln.qset_hash
        candidates = self._leader_candidates
        top_priority, leaders = 0, set()
        for n in candidates:
            p = self._node_priority(n)
            if p > top_priority:
                top_priority, leaders = p, {n}
            elif p == top_priority and p > 0:
                leaders.add(n)
        self.round_leaders |= leaders  # leaders accumulate across rounds

    # --- value adoption ---------------------------------------------------
    def _validate(self, value: bytes) -> Optional[bytes]:
        lvl = self.slot.driver.validate_value(self.slot.slot_index, value,
                                              nomination=True)
        if lvl in (ValidationLevel.FULLY_VALIDATED,
                   ValidationLevel.VOTE_TO_NOMINATE):
            return value
        # Any non-fully-valid value (INVALID included) goes through
        # extract_valid_value, which may repair it by stripping unwanted
        # upgrades (reference: getNewValueFromNomination calls
        # extractValidValue for every non-fully-valid value).
        return self.slot.driver.extract_valid_value(self.slot.slot_index,
                                                    value)

    def _value_from_nomination(self, nom) -> Optional[bytes]:
        """Highest-value-hash valid value from one nomination statement.
        Reference: NominationProtocol::getNewValueFromNomination."""
        d = self.slot.driver
        best, best_hash = None, -1
        for v in list(nom.votes) + list(nom.accepted):
            vv = self._validate(v)
            if vv is None:
                continue
            h = d.compute_value_hash(self.slot.slot_index,
                                     self.previous_value,
                                     self.round_number, vv)
            if h > best_hash:
                best, best_hash = vv, h
        return best

    def _new_value_from_leaders(self) -> Optional[bytes]:
        d = self.slot.driver
        best, best_hash = None, -1
        for leader in self.round_leaders:
            env = self.latest_nominations.get(leader)
            if env is None:
                continue
            v = self._value_from_nomination(self._nom(env.statement))
            if v is None:
                continue
            h = d.compute_value_hash(self.slot.slot_index,
                                     self.previous_value,
                                     self.round_number, v)
            if h > best_hash:
                best, best_hash = v, h
        return best

    # --- emission ---------------------------------------------------------
    def _emit_nomination(self) -> None:
        st = SX.SCPStatement(
            nodeID=self.slot.local_node_xdr_id(),
            slotIndex=self.slot.slot_index,
            pledges=SX.SCPStatementPledges.nominate(SX.SCPNomination(
                quorumSetHash=self.slot.local_node.qset_hash,
                votes=sorted(self.votes),
                accepted=sorted(self.accepted))))
        env = self.slot.create_envelope(st)
        # process our own statement first (reference: emits only if valid)
        if self.process_envelope(env, self_env=True):
            if (self.last_envelope is None
                    or self._is_newer(env.statement,
                                      self.last_envelope.statement)):
                self.last_envelope = env
                if self.slot.fully_validated:
                    self.slot.driver.emit_envelope(env)

    # --- protocol entry points -------------------------------------------
    def nominate(self, value: bytes, previous_value: bytes,
                 timed_out: bool) -> bool:
        """Called by herder (round 1) and by the round timer (timed_out)."""
        if timed_out and not self.nomination_started:
            return False
        self.nomination_started = True
        self.previous_value = previous_value
        self.round_number += 1
        self.update_round_leaders()

        updated = False
        if self.slot.local_node.node_id in self.round_leaders:
            if value not in self.votes:
                vv = self._validate(value)
                if vv is not None:
                    self.votes.add(vv)
                    updated = True
        # always also adopt this round's best value from every leader's stored
        # nomination — votes only grow, and without this, rounds where every
        # node is its own (accumulated) leader would stop exchanging values
        # and nomination would livelock.
        v = self._new_value_from_leaders()
        if v is not None and v not in self.votes:
            self.votes.add(v)
            updated = True

        d = self.slot.driver
        timeout = d.compute_timeout(self.round_number, is_nomination=True)
        d.nominating_value(self.slot.slot_index, value)
        d.setup_timer(
            self.slot.slot_index, NOMINATION_TIMER, timeout,
            lambda: self.slot.nominate(value, previous_value, timed_out=True))
        if updated:
            self._emit_nomination()
        return updated

    def stop_nomination(self) -> None:
        self.nomination_started = False
        self.slot.driver.stop_timer(self.slot.slot_index, NOMINATION_TIMER)

    def process_envelope(self, env, self_env: bool = False) -> bool:
        """Returns True if the envelope was valid and processed."""
        st = env.statement
        nid = st.nodeID.value
        if not self._sane(st):
            return False
        old = self.latest_nominations.get(nid)
        nom_st = self._nom(st)
        votes_f = frozenset(nom_st.votes)
        accepted_f = frozenset(nom_st.accepted)
        new_total = len(nom_st.votes) + len(nom_st.accepted)
        old_summary = self._summaries.get(nid)
        if old is not None:
            # newer-statement check against the compiled-frozenset
            # registry — no XDR re-walk of the superseded statement
            if old_summary is not None:
                if not _newer_by_summary(votes_f, accepted_f, new_total,
                                         old_summary,
                                         self._summary_sizes[nid]):
                    return False
            elif not self._is_newer(st, old.statement):
                return False
        self.latest_nominations[nid] = env
        self._summaries[nid] = (votes_f, accepted_f)
        self._summary_sizes[nid] = new_total
        for v in (votes_f if old_summary is None
                  else votes_f - old_summary[0]):
            self._voted_nom.setdefault(v, set()).add(nid)
        for v in (accepted_f if old_summary is None
                  else accepted_f - old_summary[1]):
            self._accepted_nom.setdefault(v, set()).add(nid)
        self.index.note_statement(nid, 0, self.slot.qset_of_statement(st),
                                  Q.statement_qset_hash(st))
        if not self.nomination_started:
            return True

        ln = self.slot.local_node
        nom = self._nom(st)
        modified = new_candidates = False
        empty: set = set()

        for v in list(nom.votes) + list(nom.accepted):
            if v in self.accepted:
                continue
            if ln.federated_accept_sets(
                    self._voted_nom.get(v, empty),
                    self._accepted_nom.get(v, empty),
                    index=self.index, key=("nom-acc", v), latch=True):
                vv = self._validate(v)
                if vv is None:
                    continue
                self.accepted.add(v)
                self.votes.add(v)
                modified = True
        for v in self.accepted - self.candidates:
            if ln.federated_ratify_sets(
                    self._accepted_nom.get(v, empty),
                    index=self.index, key=("nom-rat", v), latch=True):
                self.candidates.add(v)
                new_candidates = True

        # a round leader's nomination arrived: adopt its best value
        # (reference: processEnvelope → getNewValueFromNomination)
        if not self_env and nid in self.round_leaders:
            v = self._value_from_nomination(nom)
            if v is not None and v not in self.votes:
                self.votes.add(v)
                modified = True

        if modified:
            # also on self_env: accepting values while processing our own
            # statement must still be announced (the recursion terminates —
            # votes/accepted only grow, and unchanged state isn't re-emitted)
            self._emit_nomination()
        if new_candidates:
            composite = self.slot.driver.combine_candidates(
                self.slot.slot_index, sorted(self.candidates))
            if composite is not None:
                self.latest_composite = composite
                self.slot.driver.updated_candidate_value(
                    self.slot.slot_index, composite)
                self.slot.bump_state(composite, force=False)
        return True

    def get_latest_message(self, node_id: bytes):
        return self.latest_nominations.get(node_id)

    def current_state(self) -> List:
        return [self.last_envelope] if self.last_envelope else []
