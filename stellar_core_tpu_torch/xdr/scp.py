"""Stellar-SCP.x equivalents (reference: src/protocol-curr/xdr/Stellar-SCP.x)."""

from .codec import (Int32, Opaque, Optional, Uint32, Uint64, VarArray,
                    VarOpaque, xdr_enum, xdr_struct, xdr_union)
from .types import Hash, NodeID, Signature

Value = VarOpaque()

SCPBallot = xdr_struct("SCPBallot", [
    ("counter", Uint32),
    ("value", Value),
])

SCPStatementType = xdr_enum("SCPStatementType", {
    "SCP_ST_PREPARE": 0,
    "SCP_ST_CONFIRM": 1,
    "SCP_ST_EXTERNALIZE": 2,
    "SCP_ST_NOMINATE": 3,
})

SCPNomination = xdr_struct("SCPNomination", [
    ("quorumSetHash", Hash),
    ("votes", VarArray(Value)),
    ("accepted", VarArray(Value)),
])

SCPPrepare = xdr_struct("SCPPrepare", [
    ("quorumSetHash", Hash),
    ("ballot", SCPBallot),
    ("prepared", Optional(SCPBallot)),
    ("preparedPrime", Optional(SCPBallot)),
    ("nC", Uint32),
    ("nH", Uint32),
], defaults={"prepared": None, "preparedPrime": None, "nC": 0, "nH": 0})

SCPConfirm = xdr_struct("SCPConfirm", [
    ("ballot", SCPBallot),
    ("nPrepared", Uint32),
    ("nCommit", Uint32),
    ("nH", Uint32),
    ("quorumSetHash", Hash),
])

SCPExternalize = xdr_struct("SCPExternalize", [
    ("commit", SCPBallot),
    ("nH", Uint32),
    ("commitQuorumSetHash", Hash),
])

SCPStatementPledges = xdr_union("SCPStatementPledges", SCPStatementType, {
    SCPStatementType.SCP_ST_PREPARE: ("prepare", SCPPrepare),
    SCPStatementType.SCP_ST_CONFIRM: ("confirm", SCPConfirm),
    SCPStatementType.SCP_ST_EXTERNALIZE: ("externalize", SCPExternalize),
    SCPStatementType.SCP_ST_NOMINATE: ("nominate", SCPNomination),
})

SCPStatement = xdr_struct("SCPStatement", [
    ("nodeID", NodeID),
    ("slotIndex", Uint64),
    ("pledges", SCPStatementPledges),
])

SCPEnvelope = xdr_struct("SCPEnvelope", [
    ("statement", SCPStatement),
    ("signature", Signature),
])


from .codec import XdrType as _XdrType  # noqa: E402


class _SCPQuorumSetFwd(_XdrType):
    _target = None

    def pack_into(self, val, out):
        self._target.pack_into(val, out)

    def unpack_from(self, buf, off):
        return self._target.unpack_from(buf, off)


_qs_fwd = _SCPQuorumSetFwd()

SCPQuorumSet = xdr_struct("SCPQuorumSet", [
    ("threshold", Uint32),
    ("validators", VarArray(NodeID)),
    ("innerSets", VarArray(_qs_fwd)),
], defaults={"validators": list, "innerSets": list})
_SCPQuorumSetFwd._target = SCPQuorumSet._xdr_adapter()
