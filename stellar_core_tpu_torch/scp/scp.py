"""SCP — top-level protocol object owning slots.

Reference: src/scp/SCP.{h,cpp} — receiveEnvelope, nominate,
getLatestMessagesSend, purgeSlots, empty envelope/state accessors.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .driver import SCPDriver
from .local_node import LocalNode
from .slot import Slot


class EnvelopeState:
    INVALID = 0
    VALID = 1


class SCP:
    def __init__(self, driver: SCPDriver, node_id: bytes, is_validator: bool,
                 qset):
        self.driver = driver
        self.local_node = LocalNode(node_id, qset, is_validator)
        self.slots: Dict[int, Slot] = {}

    def get_slot(self, slot_index: int, create: bool = True) -> Optional[Slot]:
        s = self.slots.get(slot_index)
        if s is None and create:
            s = Slot(slot_index, self)
            self.slots[slot_index] = s
        return s

    # --- envelope intake ---------------------------------------------------
    def receive_envelope(self, env) -> int:
        if not self.driver.verify_envelope(env):
            return EnvelopeState.INVALID
        slot = self.get_slot(env.statement.slotIndex)
        ok = slot.process_envelope(env)
        return EnvelopeState.VALID if ok else EnvelopeState.INVALID

    # --- consensus drive ---------------------------------------------------
    def nominate(self, slot_index: int, value: bytes,
                 previous_value: bytes) -> bool:
        if not self.local_node.is_validator:
            # watchers never cast votes (reference: SCP::nominate returns
            # false after logging)
            return False
        return self.get_slot(slot_index).nominate(value, previous_value)

    def stop_nomination(self, slot_index: int) -> None:
        s = self.get_slot(slot_index, create=False)
        if s is not None:
            s.stop_nomination()

    # --- state access ------------------------------------------------------
    def update_local_quorum_set(self, qset) -> None:
        self.local_node.update_qset(qset)

    def get_latest_messages_send(self, slot_index: int) -> List:
        s = self.get_slot(slot_index, create=False)
        return s.get_latest_messages_send() if s is not None else []

    def get_current_state(self, slot_index: int) -> List:
        s = self.get_slot(slot_index, create=False)
        return s.get_current_state() if s is not None else []

    def get_externalized_value(self, slot_index: int) -> Optional[bytes]:
        s = self.get_slot(slot_index, create=False)
        return s.externalized_value() if s is not None else None

    def get_high_slot_index(self) -> int:
        return max(self.slots) if self.slots else 0

    def get_low_slot_index(self) -> int:
        return min(self.slots) if self.slots else 0

    def purge_slots(self, max_slot_index: int, keep: int = 0) -> None:
        """Drop state for slots below max_slot_index (reference:
        SCP::purgeSlots; `keep` retains some history for getMoreSCPState)."""
        cutoff = max_slot_index - keep
        for idx in [i for i in self.slots if i < cutoff]:
            del self.slots[idx]

    def empty(self) -> bool:
        return not self.slots
