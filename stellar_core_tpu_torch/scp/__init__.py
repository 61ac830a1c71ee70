"""Pure SCP (Stellar Consensus Protocol) library — federated Byzantine
agreement with open membership via quorum slices.

Reference: src/scp/ — reusable library depending only on XDR + crypto + util
(SURVEY.md §1 layer 7).  No app dependencies; the herder implements SCPDriver.
"""

from .ballot import (PHASE_CONFIRM, PHASE_EXTERNALIZE,  # noqa: F401
                     PHASE_PREPARE, BallotProtocol)
from .driver import (BALLOT_PROTOCOL_TIMER, NOMINATION_TIMER,  # noqa: F401
                     SCPDriver, ValidationLevel)
from .local_node import LocalNode  # noqa: F401
from .nomination import NominationProtocol  # noqa: F401
from .quorum import (find_closest_v_blocking, is_qset_sane,  # noqa: F401
                     is_quorum, is_quorum_slice, is_v_blocking,
                     normalize_qset, qset_hash, qset_nodes, singleton_qset)
from .scp import SCP, EnvelopeState  # noqa: F401
from .slot import Slot  # noqa: F401
