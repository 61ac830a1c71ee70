"""Stellar-ledger.x equivalents (reference: src/protocol-curr/xdr/Stellar-ledger.x):
LedgerHeader, StellarValue, upgrades, transaction sets (classic + generalized),
history entries, bucket entries, ledger close meta."""

from .codec import (FixedArray, Int32, Int64, Opaque, Optional, Uint32, Uint64,
                    VarArray, VarOpaque, XdrString, xdr_enum, xdr_struct,
                    xdr_union)
from .types import (ExtensionPoint, Hash, NodeID, PoolID, SequenceNumber,
                    Signature, TimePoint, Uint256)
from .ledger_entries import LedgerEntry, LedgerKey
from .transaction import (TransactionEnvelope, TransactionResultPair,
                          TransactionResultCode)

MAX_TX_PER_LEDGER = 2000

UpgradeType = VarOpaque(128)

StellarValueType = xdr_enum("StellarValueType", {
    "STELLAR_VALUE_BASIC": 0,
    "STELLAR_VALUE_SIGNED": 1,
})

LedgerCloseValueSignature = xdr_struct("LedgerCloseValueSignature", [
    ("nodeID", NodeID),
    ("signature", Signature),
])

_StellarValueExt = xdr_union("StellarValueExt", StellarValueType, {
    StellarValueType.STELLAR_VALUE_BASIC: ("basic", None),
    StellarValueType.STELLAR_VALUE_SIGNED: ("lcValueSignature", LedgerCloseValueSignature),
})

StellarValue = xdr_struct("StellarValue", [
    ("txSetHash", Hash),
    ("closeTime", TimePoint),
    ("upgrades", VarArray(UpgradeType, 6)),
    ("ext", _StellarValueExt),
], defaults={"upgrades": list, "ext": lambda: _StellarValueExt.basic()})

LedgerHeaderFlags = xdr_enum("LedgerHeaderFlags", {
    "DISABLE_LIQUIDITY_POOL_TRADING_FLAG": 0x1,
    "DISABLE_LIQUIDITY_POOL_DEPOSIT_FLAG": 0x2,
    "DISABLE_LIQUIDITY_POOL_WITHDRAWAL_FLAG": 0x4,
})

LedgerHeaderExtensionV1 = xdr_struct("LedgerHeaderExtensionV1", [
    ("flags", Uint32),
    ("ext", xdr_union("LedgerHeaderExtensionV1Ext", Int32, {0: ("v0", None)})),
])

_LedgerHeaderExt = xdr_union("LedgerHeaderExt", Int32, {
    0: ("v0", None),
    1: ("v1", LedgerHeaderExtensionV1),
})

LedgerHeader = xdr_struct("LedgerHeader", [
    ("ledgerVersion", Uint32),
    ("previousLedgerHash", Hash),
    ("scpValue", StellarValue),
    ("txSetResultHash", Hash),
    ("bucketListHash", Hash),
    ("ledgerSeq", Uint32),
    ("totalCoins", Int64),
    ("feePool", Int64),
    ("inflationSeq", Uint32),
    ("idPool", Uint64),
    ("baseFee", Uint32),
    ("baseReserve", Uint32),
    ("maxTxSetSize", Uint32),
    ("skipList", FixedArray(Hash, 4)),
    ("ext", _LedgerHeaderExt),
], defaults={"ext": lambda: _LedgerHeaderExt.v0()})

LedgerUpgradeType = xdr_enum("LedgerUpgradeType", {
    "LEDGER_UPGRADE_VERSION": 1,
    "LEDGER_UPGRADE_BASE_FEE": 2,
    "LEDGER_UPGRADE_MAX_TX_SET_SIZE": 3,
    "LEDGER_UPGRADE_BASE_RESERVE": 4,
    "LEDGER_UPGRADE_FLAGS": 5,
    "LEDGER_UPGRADE_CONFIG": 6,
    "LEDGER_UPGRADE_MAX_SOROBAN_TX_SET_SIZE": 7,
})

ConfigUpgradeSetKey = xdr_struct("ConfigUpgradeSetKey", [
    ("contractID", Hash),
    ("contentHash", Hash),
])

LedgerUpgrade = xdr_union("LedgerUpgrade", LedgerUpgradeType, {
    LedgerUpgradeType.LEDGER_UPGRADE_VERSION: ("newLedgerVersion", Uint32),
    LedgerUpgradeType.LEDGER_UPGRADE_BASE_FEE: ("newBaseFee", Uint32),
    LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE: ("newMaxTxSetSize", Uint32),
    LedgerUpgradeType.LEDGER_UPGRADE_BASE_RESERVE: ("newBaseReserve", Uint32),
    LedgerUpgradeType.LEDGER_UPGRADE_FLAGS: ("newFlags", Uint32),
    LedgerUpgradeType.LEDGER_UPGRADE_CONFIG: ("newConfig", ConfigUpgradeSetKey),
    LedgerUpgradeType.LEDGER_UPGRADE_MAX_SOROBAN_TX_SET_SIZE:
        ("newMaxSorobanTxSetSize", Uint32),
})

# --- transaction sets ---

TransactionSet = xdr_struct("TransactionSet", [
    ("previousLedgerHash", Hash),
    ("txs", VarArray(TransactionEnvelope)),
])

# Generalized tx set (protocol 20+): phases of components with optional
# discounted base fee.
TxSetComponentType = xdr_enum("TxSetComponentType", {
    "TXSET_COMP_TXS_MAYBE_DISCOUNTED_FEE": 0,
})

_TxsMaybeDiscountedFee = xdr_struct("TxSetComponentTxsMaybeDiscountedFee", [
    ("baseFee", Optional(Int64)),
    ("txs", VarArray(TransactionEnvelope)),
])

TxSetComponent = xdr_union("TxSetComponent", TxSetComponentType, {
    TxSetComponentType.TXSET_COMP_TXS_MAYBE_DISCOUNTED_FEE:
        ("txsMaybeDiscountedFee", _TxsMaybeDiscountedFee),
})

TransactionPhase = xdr_union("TransactionPhase", Int32, {
    0: ("v0Components", VarArray(TxSetComponent)),
})

TransactionSetV1 = xdr_struct("TransactionSetV1", [
    ("previousLedgerHash", Hash),
    ("phases", VarArray(TransactionPhase)),
])

GeneralizedTransactionSet = xdr_union("GeneralizedTransactionSet", Int32, {
    1: ("v1TxSet", TransactionSetV1),
})

# public aliases (the soroban tx-set builder constructs components, the
# ledger manager builds generalized history-entry exts)
TxSetComponentTxsMaybeDiscountedFee = _TxsMaybeDiscountedFee

# --- history entries ---

_THEExt = xdr_union("TransactionHistoryEntryExt", Int32, {
    0: ("v0", None),
    1: ("generalizedTxSet", GeneralizedTransactionSet),
})

TransactionHistoryEntry = xdr_struct("TransactionHistoryEntry", [
    ("ledgerSeq", Uint32),
    ("txSet", TransactionSet),
    ("ext", _THEExt),
], defaults={"ext": lambda: _THEExt.v0()})

TransactionHistoryEntryExt = _THEExt

TransactionResultSet = xdr_struct("TransactionResultSet", [
    ("results", VarArray(TransactionResultPair)),
])

_THREExt = xdr_union("TransactionHistoryResultEntryExt", Int32, {0: ("v0", None)})

TransactionHistoryResultEntry = xdr_struct("TransactionHistoryResultEntry", [
    ("ledgerSeq", Uint32),
    ("txResultSet", TransactionResultSet),
    ("ext", _THREExt),
], defaults={"ext": lambda: _THREExt.v0()})

LedgerHeaderHistoryEntryExt = xdr_union("LedgerHeaderHistoryEntryExt", Int32,
                                        {0: ("v0", None)})

LedgerHeaderHistoryEntry = xdr_struct("LedgerHeaderHistoryEntry", [
    ("hash", Hash),
    ("header", LedgerHeader),
    ("ext", LedgerHeaderHistoryEntryExt),
], defaults={"ext": lambda: LedgerHeaderHistoryEntryExt.v0()})

# --- SCP history ---

from .scp import SCPEnvelope, SCPQuorumSet  # noqa: E402

LedgerSCPMessages = xdr_struct("LedgerSCPMessages", [
    ("ledgerSeq", Uint32),
    ("messages", VarArray(SCPEnvelope)),
])

SCPHistoryEntryV0 = xdr_struct("SCPHistoryEntryV0", [
    ("quorumSets", VarArray(SCPQuorumSet)),
    ("ledgerMessages", LedgerSCPMessages),
])

SCPHistoryEntry = xdr_union("SCPHistoryEntry", Int32, {
    0: ("v0", SCPHistoryEntryV0),
})

# --- bucket entries ---

BucketEntryType = xdr_enum("BucketEntryType", {
    "METAENTRY": -1,
    "LIVEENTRY": 0,
    "DEADENTRY": 1,
    "INITENTRY": 2,
})

BucketListType = xdr_enum("BucketListType", {
    "LIVE": 0,
    "HOT_ARCHIVE": 1,
})

_BucketMetadataExt = xdr_union("BucketMetadataExt", Int32, {
    0: ("v0", None),
    1: ("bucketListType", BucketListType),
})

BucketMetadata = xdr_struct("BucketMetadata", [
    ("ledgerVersion", Uint32),
    ("ext", _BucketMetadataExt),
], defaults={"ext": lambda: _BucketMetadataExt.v0()})

BucketEntry = xdr_union("BucketEntry", BucketEntryType, {
    BucketEntryType.LIVEENTRY: ("liveEntry", LedgerEntry),
    BucketEntryType.INITENTRY: ("initEntry", LedgerEntry),
    BucketEntryType.DEADENTRY: ("deadEntry", LedgerKey),
    BucketEntryType.METAENTRY: ("metaEntry", BucketMetadata),
})

# --- ledger close meta (observability firehose; simplified v0 shape) ---

TransactionResultMeta = xdr_struct("TransactionResultMeta", [
    ("result", TransactionResultPair),
    ("feeProcessing", VarOpaque()),     # LedgerEntryChanges carried opaque for now
    ("txApplyProcessing", VarOpaque()),
])

UpgradeEntryMeta = xdr_struct("UpgradeEntryMeta", [
    ("upgrade", LedgerUpgrade),
    ("changes", VarOpaque()),
])

LedgerCloseMetaV0 = xdr_struct("LedgerCloseMetaV0", [
    ("ledgerHeader", LedgerHeaderHistoryEntry),
    ("txSet", TransactionSet),
    ("txProcessing", VarArray(TransactionResultMeta)),
    ("upgradesProcessing", VarArray(UpgradeEntryMeta)),
    ("scpInfo", VarArray(SCPHistoryEntry)),
])

LedgerCloseMeta = xdr_union("LedgerCloseMeta", Int32, {
    0: ("v0", LedgerCloseMetaV0),
})
