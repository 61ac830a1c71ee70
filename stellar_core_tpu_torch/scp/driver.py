"""SCPDriver — the abstract callback seam between the pure SCP library and
the application (herder).

Reference: src/scp/SCPDriver.{h,cpp} — validateValue, combineCandidates,
emitEnvelope, getQSet, setupTimer, computeHashNode, computeValueHash,
computeTimeout, signEnvelope/verifyEnvelope.
"""

from __future__ import annotations

import struct
from enum import Enum
from typing import List, Optional

from ..crypto.sha import sha256


class ValidationLevel(Enum):
    INVALID = 0
    MAYBE_VALID = 1          # valid signature-wise but can't fully check yet
    FULLY_VALIDATED = 2
    VOTE_TO_NOMINATE = 3     # fully validated and worth nominating


# timer slot ids (reference: Slot::timerIDs)
NOMINATION_TIMER = 0
BALLOT_PROTOCOL_TIMER = 1

_HASH_N = 1  # isPriority=false → neighborhood hash
_HASH_P = 2  # isPriority=true  → priority hash
_HASH_K = 3  # value hash

MAX_TIMEOUT_SECONDS = 30 * 60


class SCPDriver:
    """Subclass and implement; all values are opaque bytes."""

    # --- value semantics -------------------------------------------------
    def validate_value(self, slot_index: int, value: bytes,
                       nomination: bool) -> ValidationLevel:
        return ValidationLevel.MAYBE_VALID

    def extract_valid_value(self, slot_index: int,
                            value: bytes) -> Optional[bytes]:
        """Try to repair an invalid value into a valid one (or None)."""
        return None

    def combine_candidates(self, slot_index: int,
                           candidates: List[bytes]) -> Optional[bytes]:
        raise NotImplementedError

    # --- quorum sets ------------------------------------------------------
    def get_qset(self, qset_hash: bytes):
        """Return the SCPQuorumSet with this hash, or None if unknown."""
        raise NotImplementedError

    # --- I/O --------------------------------------------------------------
    def emit_envelope(self, envelope) -> None:
        raise NotImplementedError

    def sign_envelope(self, envelope) -> None:
        pass

    def verify_envelope(self, envelope) -> bool:
        return True

    # --- notifications (optional overrides) ------------------------------
    def value_externalized(self, slot_index: int, value: bytes) -> None:
        pass

    def nominating_value(self, slot_index: int, value: bytes) -> None:
        pass

    def updated_candidate_value(self, slot_index: int, value: bytes) -> None:
        pass

    def started_ballot_protocol(self, slot_index: int, ballot) -> None:
        pass

    def accepted_ballot_prepared(self, slot_index: int, ballot) -> None:
        pass

    def confirmed_ballot_prepared(self, slot_index: int, ballot) -> None:
        pass

    def accepted_commit(self, slot_index: int, ballot) -> None:
        pass

    def ballot_did_hear_from_quorum(self, slot_index: int, ballot) -> None:
        pass

    # --- timers -----------------------------------------------------------
    def setup_timer(self, slot_index: int, timer_id: int, timeout: float,
                    callback) -> None:
        """Arm (or, with callback=None, cancel) a per-slot timer."""
        raise NotImplementedError

    def stop_timer(self, slot_index: int, timer_id: int) -> None:
        self.setup_timer(slot_index, timer_id, 0.0, None)  # corelint: disable=float-discipline -- timer-cancel sentinel delay, local pacing

    def compute_timeout(self, round_number: int,
                        is_nomination: bool = False) -> float:
        """Reference: SCPDriver::computeTimeout — linear backoff, capped."""
        return float(min(round_number + 1, MAX_TIMEOUT_SECONDS))  # corelint: disable=float-discipline -- timer backoff seconds, local pacing; float(int) exact

    # --- deterministic hashing for leader election ------------------------
    def _hash_expr(self, slot_index: int, prev: bytes, tag: int,
                   extra: bytes) -> int:
        h = sha256(struct.pack(">QI", slot_index, tag) + prev + extra)
        return int.from_bytes(h[:8], "big")

    def compute_hash_node(self, slot_index: int, prev: bytes,
                          is_priority: bool, round_number: int,
                          node_id: bytes) -> int:
        tag = _HASH_P if is_priority else _HASH_N
        return self._hash_expr(slot_index, prev, tag,
                               struct.pack(">i", round_number) + node_id)

    def compute_value_hash(self, slot_index: int, prev: bytes,
                           round_number: int, value: bytes) -> int:
        return self._hash_expr(slot_index, prev, _HASH_K,
                               struct.pack(">i", round_number) + value)
