"""Slot — one consensus round (ledger sequence number): nomination + ballot
protocol plus envelope signing/bookkeeping.

Reference: src/scp/Slot.{h,cpp} — processEnvelope, getLatestMessagesSend,
createEnvelope, federated voting delegated to LocalNode.
"""

from __future__ import annotations

from typing import List, Optional

from ..xdr import scp as SX
from ..xdr import types as XT
from .ballot import BallotProtocol
from .nomination import NominationProtocol
from .quorum import statement_qset_hash

StType = SX.SCPStatementType


class Slot:
    def __init__(self, slot_index: int, scp):
        self.slot_index = slot_index
        self.scp = scp
        self.driver = scp.driver
        self.local_node = scp.local_node
        self.nomination = NominationProtocol(self)
        self.ballot = BallotProtocol(self)
        self.fully_validated = scp.local_node.is_validator
        self.got_v_blocking = False
        self._historical: List = []  # all envelopes seen (for debugging)

    # --- helpers used by sub-protocols ------------------------------------
    def local_node_xdr_id(self):
        return XT.node_id(self.local_node.node_id)

    def qset_of_statement(self, st):
        """Quorum set referenced by a statement (None if unknown)."""
        h = statement_qset_hash(st)
        if st.nodeID.value == self.local_node.node_id \
                and h == self.local_node.qset_hash:
            return self.local_node.qset
        return self.driver.get_qset(h)

    def create_envelope(self, statement):
        env = SX.SCPEnvelope(statement=statement, signature=b"\x00" * 64)
        self.driver.sign_envelope(env)
        return env

    # --- entry points ------------------------------------------------------
    def process_envelope(self, env, self_env: bool = False) -> bool:
        st = env.statement
        assert st.slotIndex == self.slot_index
        if self.qset_of_statement(st) is None:
            return False  # herder fetches the qset first (PendingEnvelopes)
        self._historical.append(env)
        if st.pledges.type == StType.SCP_ST_NOMINATE:
            ok = self.nomination.process_envelope(env, self_env)
        else:
            ok = self.ballot.process_envelope(env, self_env)
        if ok and not self_env:
            self._maybe_fully_validate()
        return ok

    def _maybe_fully_validate(self) -> None:
        """A non-validator slot becomes fully validated once a v-blocking set
        has issued ballot statements (reference: Slot::maybeSetGotVBlocking —
        simplified)."""
        if self.fully_validated:
            return
        nodes = set(self.ballot.latest_envelopes)
        if self.local_node.is_v_blocking(nodes):
            self.got_v_blocking = True
            self.fully_validated = True

    def nominate(self, value: bytes, previous_value: bytes,
                 timed_out: bool = False) -> bool:
        return self.nomination.nominate(value, previous_value, timed_out)

    def stop_nomination(self) -> None:
        self.nomination.stop_nomination()

    def bump_state(self, value: bytes, force: bool) -> bool:
        return self.ballot.bump_state(value, force)

    def abandon_ballot(self, n: int = 0) -> bool:
        return self.ballot.abandon_ballot(n)

    # --- state access ------------------------------------------------------
    def get_latest_messages_send(self) -> List:
        """Messages to (re)broadcast for this slot."""
        if not self.fully_validated:
            return []
        return self.nomination.current_state() + self.ballot.current_state()

    def get_latest_message(self, node_id: bytes):
        env = self.ballot.get_latest_message(node_id)
        if env is None:
            env = self.nomination.get_latest_message(node_id)
        return env

    def get_current_state(self) -> List:
        out = []
        # sorted(): the union iterates in hash order, and this list is
        # handed to the overlay as broadcast/pull order
        for n in sorted(set(self.nomination.latest_nominations) | set(
                self.ballot.latest_envelopes)):
            e = self.ballot.latest_envelopes.get(n)
            if e is not None:
                out.append(e)
            e = self.nomination.latest_nominations.get(n)
            if e is not None:
                out.append(e)
        return out

    def externalized_value(self) -> Optional[bytes]:
        return self.ballot.externalized_value()
