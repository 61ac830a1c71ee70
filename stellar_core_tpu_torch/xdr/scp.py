"""The two XDR types the quorum-intersection checker reads.

Counterparts of ``stellar_core_tpu.xdr.types.NodeID`` and
``stellar_core_tpu.xdr.scp.SCPQuorumSet``, with the same field names, so
the checker's code reads the JAX package's XDR objects and these alike.
There is no codec here: only what the checker touches (``NodeID.value``,
``SCPQuorumSet.threshold``, ``.validators``, ``.innerSets``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class NodeID:
    """An ed25519 node id: its 32 raw key bytes."""
    value: bytes

    @classmethod
    def ed25519(cls, key: bytes) -> "NodeID":
        return cls(bytes(key))


@dataclass(frozen=True)
class SCPQuorumSet:
    """threshold of (validators + innerSets) must agree."""
    threshold: int
    validators: Tuple[NodeID, ...] = ()
    innerSets: Tuple["SCPQuorumSet", ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "validators", tuple(self.validators))
        object.__setattr__(self, "innerSets", tuple(self.innerSets))
