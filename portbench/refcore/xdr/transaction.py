"""Stellar-transaction.x equivalents (reference:
src/protocol-curr/xdr/Stellar-transaction.x): MuxedAccount, the 27 operation
bodies (24 classic + 3 Soroban, SURVEY.md §2.2), Transaction v0/v1, fee-bump,
envelopes, signature payloads, and the full result-code hierarchy."""

from .codec import (Bool, Int32, Int64, Opaque, Optional, Uint32, Uint64,
                    VarArray, VarOpaque, Void, XdrString, xdr_enum, xdr_struct,
                    xdr_union)
from .types import (AccountID, Duration, ExtensionPoint, Hash, Liabilities,
                    PoolID, Price, SequenceNumber, Signature, SignatureHint,
                    SignerKey, String32, String64, TimePoint, Uint256)
from .ledger_entries import (Asset, AssetCode4, AssetCode12, ClaimableBalanceID,
                             Claimant, DataValue, LedgerEntry, LedgerKey,
                             Signer, TrustLineAsset)

MAX_OPS_PER_TX = 100

from .types import CryptoKeyType  # noqa: E402

_CKT = CryptoKeyType

_MuxedAccountMed25519 = xdr_struct("MuxedAccountMed25519", [
    ("id", Uint64),
    ("ed25519", Uint256),
])

MuxedAccount = xdr_union("MuxedAccount", _CKT, {
    _CKT.KEY_TYPE_ED25519: ("ed25519", Uint256),
    _CKT.KEY_TYPE_MUXED_ED25519: ("med25519", _MuxedAccountMed25519),
})


def muxed_from_account_id(acc: "AccountID") -> "MuxedAccount":
    return MuxedAccount.ed25519(acc.value)


def muxed_to_account_id(m: "MuxedAccount") -> "AccountID":
    if m.switch == _CKT.KEY_TYPE_ED25519:
        return AccountID.ed25519(m.value)
    return AccountID.ed25519(m.value.ed25519)


DecoratedSignature = xdr_struct("DecoratedSignature", [
    ("hint", SignatureHint),
    ("signature", Signature),
])

OperationType = xdr_enum("OperationType", {
    "CREATE_ACCOUNT": 0,
    "PAYMENT": 1,
    "PATH_PAYMENT_STRICT_RECEIVE": 2,
    "MANAGE_SELL_OFFER": 3,
    "CREATE_PASSIVE_SELL_OFFER": 4,
    "SET_OPTIONS": 5,
    "CHANGE_TRUST": 6,
    "ALLOW_TRUST": 7,
    "ACCOUNT_MERGE": 8,
    "INFLATION": 9,
    "MANAGE_DATA": 10,
    "BUMP_SEQUENCE": 11,
    "MANAGE_BUY_OFFER": 12,
    "PATH_PAYMENT_STRICT_SEND": 13,
    "CREATE_CLAIMABLE_BALANCE": 14,
    "CLAIM_CLAIMABLE_BALANCE": 15,
    "BEGIN_SPONSORING_FUTURE_RESERVES": 16,
    "END_SPONSORING_FUTURE_RESERVES": 17,
    "REVOKE_SPONSORSHIP": 18,
    "CLAWBACK": 19,
    "CLAWBACK_CLAIMABLE_BALANCE": 20,
    "SET_TRUST_LINE_FLAGS": 21,
    "LIQUIDITY_POOL_DEPOSIT": 22,
    "LIQUIDITY_POOL_WITHDRAW": 23,
    "INVOKE_HOST_FUNCTION": 24,
    "EXTEND_FOOTPRINT_TTL": 25,
    "RESTORE_FOOTPRINT": 26,
})

# --- operation bodies (classic) ---

CreateAccountOp = xdr_struct("CreateAccountOp", [
    ("destination", AccountID),
    ("startingBalance", Int64),
])

PaymentOp = xdr_struct("PaymentOp", [
    ("destination", MuxedAccount),
    ("asset", Asset),
    ("amount", Int64),
])

PathPaymentStrictReceiveOp = xdr_struct("PathPaymentStrictReceiveOp", [
    ("sendAsset", Asset),
    ("sendMax", Int64),
    ("destination", MuxedAccount),
    ("destAsset", Asset),
    ("destAmount", Int64),
    ("path", VarArray(Asset, 5)),
])

PathPaymentStrictSendOp = xdr_struct("PathPaymentStrictSendOp", [
    ("sendAsset", Asset),
    ("sendAmount", Int64),
    ("destination", MuxedAccount),
    ("destAsset", Asset),
    ("destMin", Int64),
    ("path", VarArray(Asset, 5)),
])

ManageSellOfferOp = xdr_struct("ManageSellOfferOp", [
    ("selling", Asset),
    ("buying", Asset),
    ("amount", Int64),
    ("price", Price),
    ("offerID", Int64),
])

ManageBuyOfferOp = xdr_struct("ManageBuyOfferOp", [
    ("selling", Asset),
    ("buying", Asset),
    ("buyAmount", Int64),
    ("price", Price),
    ("offerID", Int64),
])

CreatePassiveSellOfferOp = xdr_struct("CreatePassiveSellOfferOp", [
    ("selling", Asset),
    ("buying", Asset),
    ("amount", Int64),
    ("price", Price),
])

SetOptionsOp = xdr_struct("SetOptionsOp", [
    ("inflationDest", Optional(AccountID)),
    ("clearFlags", Optional(Uint32)),
    ("setFlags", Optional(Uint32)),
    ("masterWeight", Optional(Uint32)),
    ("lowThreshold", Optional(Uint32)),
    ("medThreshold", Optional(Uint32)),
    ("highThreshold", Optional(Uint32)),
    ("homeDomain", Optional(String32)),
    ("signer", Optional(Signer)),
], defaults={f: None for f in ("inflationDest", "clearFlags", "setFlags",
                               "masterWeight", "lowThreshold", "medThreshold",
                               "highThreshold", "homeDomain", "signer")})

from .ledger_entries import (AssetType, AlphaNum4, AlphaNum12, OfferEntry,
                             LiquidityPoolConstantProductParameters,
                             LiquidityPoolType)  # noqa: E402

LiquidityPoolParameters = xdr_union("LiquidityPoolParameters", LiquidityPoolType, {
    LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT:
        ("constantProduct", LiquidityPoolConstantProductParameters),
})

ChangeTrustAsset = xdr_union("ChangeTrustAsset", AssetType, {
    AssetType.ASSET_TYPE_NATIVE: ("native", None),
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: ("alphaNum4", AlphaNum4),
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: ("alphaNum12", AlphaNum12),
    AssetType.ASSET_TYPE_POOL_SHARE: ("liquidityPool", LiquidityPoolParameters),
})

ChangeTrustOp = xdr_struct("ChangeTrustOp", [
    ("line", ChangeTrustAsset),
    ("limit", Int64),
])

AssetCode = xdr_union("AssetCode", AssetType, {
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: ("assetCode4", AssetCode4),
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: ("assetCode12", AssetCode12),
})

AllowTrustOp = xdr_struct("AllowTrustOp", [
    ("trustor", AccountID),
    ("asset", AssetCode),
    ("authorize", Uint32),
])

ManageDataOp = xdr_struct("ManageDataOp", [
    ("dataName", String64),
    ("dataValue", Optional(DataValue)),
])

BumpSequenceOp = xdr_struct("BumpSequenceOp", [
    ("bumpTo", SequenceNumber),
])

CreateClaimableBalanceOp = xdr_struct("CreateClaimableBalanceOp", [
    ("asset", Asset),
    ("amount", Int64),
    ("claimants", VarArray(Claimant, 10)),
])

ClaimClaimableBalanceOp = xdr_struct("ClaimClaimableBalanceOp", [
    ("balanceID", ClaimableBalanceID),
])

BeginSponsoringFutureReservesOp = xdr_struct("BeginSponsoringFutureReservesOp", [
    ("sponsoredID", AccountID),
])

RevokeSponsorshipType = xdr_enum("RevokeSponsorshipType", {
    "REVOKE_SPONSORSHIP_LEDGER_ENTRY": 0,
    "REVOKE_SPONSORSHIP_SIGNER": 1,
})

_RevokeSponsorshipSigner = xdr_struct("RevokeSponsorshipOpSigner", [
    ("accountID", AccountID),
    ("signerKey", SignerKey),
])

RevokeSponsorshipOp = xdr_union("RevokeSponsorshipOp", RevokeSponsorshipType, {
    RevokeSponsorshipType.REVOKE_SPONSORSHIP_LEDGER_ENTRY: ("ledgerKey", LedgerKey),
    RevokeSponsorshipType.REVOKE_SPONSORSHIP_SIGNER: ("signer", _RevokeSponsorshipSigner),
})

ClawbackOp = xdr_struct("ClawbackOp", [
    ("asset", Asset),
    ("from_", MuxedAccount),
    ("amount", Int64),
])

ClawbackClaimableBalanceOp = xdr_struct("ClawbackClaimableBalanceOp", [
    ("balanceID", ClaimableBalanceID),
])

SetTrustLineFlagsOp = xdr_struct("SetTrustLineFlagsOp", [
    ("trustor", AccountID),
    ("asset", Asset),
    ("clearFlags", Uint32),
    ("setFlags", Uint32),
])

LiquidityPoolDepositOp = xdr_struct("LiquidityPoolDepositOp", [
    ("liquidityPoolID", PoolID),
    ("maxAmountA", Int64),
    ("maxAmountB", Int64),
    ("minPrice", Price),
    ("maxPrice", Price),
])

LiquidityPoolWithdrawOp = xdr_struct("LiquidityPoolWithdrawOp", [
    ("liquidityPoolID", PoolID),
    ("amount", Int64),
    ("minAmountA", Int64),
    ("minAmountB", Int64),
])

# Soroban ops.  The wasm HOST is out of scope (SURVEY.md §2.4 capability
# gap — apply yields opNOT_SUPPORTED), but the schema is real: HostFunction,
# SCVal and the auth tree live in contract.py, so Soroban-carrying envelopes
# decode and round-trip byte-exactly.
from .contract import HostFunction, SorobanAuthorizationEntry  # noqa: E402

InvokeHostFunctionOp = xdr_struct("InvokeHostFunctionOp", [
    ("hostFunction", HostFunction),
    ("auth", VarArray(SorobanAuthorizationEntry)),
], defaults={"auth": list})
ExtendFootprintTTLOp = xdr_struct("ExtendFootprintTTLOp", [
    ("ext", ExtensionPoint),
    ("extendTo", Uint32),
])
RestoreFootprintOp = xdr_struct("RestoreFootprintOp", [
    ("ext", ExtensionPoint),
])

OperationBody = xdr_union("OperationBody", OperationType, {
    OperationType.CREATE_ACCOUNT: ("createAccountOp", CreateAccountOp),
    OperationType.PAYMENT: ("paymentOp", PaymentOp),
    OperationType.PATH_PAYMENT_STRICT_RECEIVE:
        ("pathPaymentStrictReceiveOp", PathPaymentStrictReceiveOp),
    OperationType.MANAGE_SELL_OFFER: ("manageSellOfferOp", ManageSellOfferOp),
    OperationType.CREATE_PASSIVE_SELL_OFFER:
        ("createPassiveSellOfferOp", CreatePassiveSellOfferOp),
    OperationType.SET_OPTIONS: ("setOptionsOp", SetOptionsOp),
    OperationType.CHANGE_TRUST: ("changeTrustOp", ChangeTrustOp),
    OperationType.ALLOW_TRUST: ("allowTrustOp", AllowTrustOp),
    OperationType.ACCOUNT_MERGE: ("destination", MuxedAccount),
    OperationType.INFLATION: ("inflation", None),
    OperationType.MANAGE_DATA: ("manageDataOp", ManageDataOp),
    OperationType.BUMP_SEQUENCE: ("bumpSequenceOp", BumpSequenceOp),
    OperationType.MANAGE_BUY_OFFER: ("manageBuyOfferOp", ManageBuyOfferOp),
    OperationType.PATH_PAYMENT_STRICT_SEND:
        ("pathPaymentStrictSendOp", PathPaymentStrictSendOp),
    OperationType.CREATE_CLAIMABLE_BALANCE:
        ("createClaimableBalanceOp", CreateClaimableBalanceOp),
    OperationType.CLAIM_CLAIMABLE_BALANCE:
        ("claimClaimableBalanceOp", ClaimClaimableBalanceOp),
    OperationType.BEGIN_SPONSORING_FUTURE_RESERVES:
        ("beginSponsoringFutureReservesOp", BeginSponsoringFutureReservesOp),
    OperationType.END_SPONSORING_FUTURE_RESERVES:
        ("endSponsoringFutureReserves", None),
    OperationType.REVOKE_SPONSORSHIP: ("revokeSponsorshipOp", RevokeSponsorshipOp),
    OperationType.CLAWBACK: ("clawbackOp", ClawbackOp),
    OperationType.CLAWBACK_CLAIMABLE_BALANCE:
        ("clawbackClaimableBalanceOp", ClawbackClaimableBalanceOp),
    OperationType.SET_TRUST_LINE_FLAGS: ("setTrustLineFlagsOp", SetTrustLineFlagsOp),
    OperationType.LIQUIDITY_POOL_DEPOSIT:
        ("liquidityPoolDepositOp", LiquidityPoolDepositOp),
    OperationType.LIQUIDITY_POOL_WITHDRAW:
        ("liquidityPoolWithdrawOp", LiquidityPoolWithdrawOp),
    OperationType.INVOKE_HOST_FUNCTION: ("invokeHostFunctionOp", InvokeHostFunctionOp),
    OperationType.EXTEND_FOOTPRINT_TTL: ("extendFootprintTTLOp", ExtendFootprintTTLOp),
    OperationType.RESTORE_FOOTPRINT: ("restoreFootprintOp", RestoreFootprintOp),
})

Operation = xdr_struct("Operation", [
    ("sourceAccount", Optional(MuxedAccount)),
    ("body", OperationBody),
], defaults={"sourceAccount": None})

MemoType = xdr_enum("MemoType", {
    "MEMO_NONE": 0,
    "MEMO_TEXT": 1,
    "MEMO_ID": 2,
    "MEMO_HASH": 3,
    "MEMO_RETURN": 4,
})

Memo = xdr_union("Memo", MemoType, {
    MemoType.MEMO_NONE: ("none", None),
    MemoType.MEMO_TEXT: ("text", XdrString(28)),
    MemoType.MEMO_ID: ("id", Uint64),
    MemoType.MEMO_HASH: ("hash", Hash),
    MemoType.MEMO_RETURN: ("retHash", Hash),
})

TimeBounds = xdr_struct("TimeBounds", [
    ("minTime", TimePoint),
    ("maxTime", TimePoint),
])

LedgerBounds = xdr_struct("LedgerBounds", [
    ("minLedger", Uint32),
    ("maxLedger", Uint32),
])

PreconditionsV2 = xdr_struct("PreconditionsV2", [
    ("timeBounds", Optional(TimeBounds)),
    ("ledgerBounds", Optional(LedgerBounds)),
    ("minSeqNum", Optional(SequenceNumber)),
    ("minSeqAge", Duration),
    ("minSeqLedgerGap", Uint32),
    ("extraSigners", VarArray(SignerKey, 2)),
], defaults={"timeBounds": None, "ledgerBounds": None, "minSeqNum": None,
             "minSeqAge": 0, "minSeqLedgerGap": 0, "extraSigners": list})

PreconditionType = xdr_enum("PreconditionType", {
    "PRECOND_NONE": 0,
    "PRECOND_TIME": 1,
    "PRECOND_V2": 2,
})

Preconditions = xdr_union("Preconditions", PreconditionType, {
    PreconditionType.PRECOND_NONE: ("none", None),
    PreconditionType.PRECOND_TIME: ("timeBounds", TimeBounds),
    PreconditionType.PRECOND_V2: ("v2", PreconditionsV2),
})

# Soroban resource declaration (protocol 20+): Transaction.ext v1.
LedgerFootprint = xdr_struct("LedgerFootprint", [
    ("readOnly", VarArray(LedgerKey)),
    ("readWrite", VarArray(LedgerKey)),
], defaults={"readOnly": list, "readWrite": list})

SorobanResources = xdr_struct("SorobanResources", [
    ("footprint", LedgerFootprint),
    ("instructions", Uint32),
    ("readBytes", Uint32),
    ("writeBytes", Uint32),
])

SorobanTransactionData = xdr_struct("SorobanTransactionData", [
    ("ext", ExtensionPoint),
    ("resources", SorobanResources),
    ("resourceFee", Int64),
])

_TxExt = xdr_union("TransactionExt", Int32, {
    0: ("v0", None),
    1: ("sorobanData", SorobanTransactionData),
})
TransactionExt = _TxExt

Transaction = xdr_struct("Transaction", [
    ("sourceAccount", MuxedAccount),
    ("fee", Uint32),
    ("seqNum", SequenceNumber),
    ("cond", Preconditions),
    ("memo", Memo),
    ("operations", VarArray(Operation, MAX_OPS_PER_TX)),
    ("ext", _TxExt),
], defaults={"cond": lambda: Preconditions.none(),
             "memo": lambda: Memo.none(),
             "ext": lambda: _TxExt.v0()})

TransactionV0 = xdr_struct("TransactionV0", [
    ("sourceAccountEd25519", Uint256),
    ("fee", Uint32),
    ("seqNum", SequenceNumber),
    ("timeBounds", Optional(TimeBounds)),
    ("memo", Memo),
    ("operations", VarArray(Operation, MAX_OPS_PER_TX)),
    ("ext", xdr_union("TransactionV0Ext", Int32, {0: ("v0", None)})),
])

TransactionV0Envelope = xdr_struct("TransactionV0Envelope", [
    ("tx", TransactionV0),
    ("signatures", VarArray(DecoratedSignature, 20)),
])

TransactionV1Envelope = xdr_struct("TransactionV1Envelope", [
    ("tx", Transaction),
    ("signatures", VarArray(DecoratedSignature, 20)),
])

EnvelopeType = xdr_enum("EnvelopeType", {
    "ENVELOPE_TYPE_TX_V0": 0,
    "ENVELOPE_TYPE_SCP": 1,
    "ENVELOPE_TYPE_TX": 2,
    "ENVELOPE_TYPE_AUTH": 3,
    "ENVELOPE_TYPE_SCPVALUE": 4,
    "ENVELOPE_TYPE_TX_FEE_BUMP": 5,
    "ENVELOPE_TYPE_OP_ID": 6,
    "ENVELOPE_TYPE_POOL_REVOKE_OP_ID": 7,
    "ENVELOPE_TYPE_CONTRACT_ID": 8,
    "ENVELOPE_TYPE_SOROBAN_AUTHORIZATION": 9,
})

_FeeBumpInnerTx = xdr_union("FeeBumpInnerTx", EnvelopeType, {
    EnvelopeType.ENVELOPE_TYPE_TX: ("v1", TransactionV1Envelope),
})

FeeBumpTransaction = xdr_struct("FeeBumpTransaction", [
    ("feeSource", MuxedAccount),
    ("fee", Int64),
    ("innerTx", _FeeBumpInnerTx),
    ("ext", xdr_union("FeeBumpTransactionExt", Int32, {0: ("v0", None)})),
])

FeeBumpTransactionEnvelope = xdr_struct("FeeBumpTransactionEnvelope", [
    ("tx", FeeBumpTransaction),
    ("signatures", VarArray(DecoratedSignature, 20)),
])

TransactionEnvelope = xdr_union("TransactionEnvelope", EnvelopeType, {
    EnvelopeType.ENVELOPE_TYPE_TX_V0: ("v0", TransactionV0Envelope),
    EnvelopeType.ENVELOPE_TYPE_TX: ("v1", TransactionV1Envelope),
    EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP: ("feeBump", FeeBumpTransactionEnvelope),
})

_TSPTaggedTx = xdr_union("TransactionSignaturePayloadTaggedTransaction", EnvelopeType, {
    EnvelopeType.ENVELOPE_TYPE_TX: ("tx", Transaction),
    EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP: ("feeBump", FeeBumpTransaction),
})

TransactionSignaturePayload = xdr_struct("TransactionSignaturePayload", [
    ("networkId", Hash),
    ("taggedTransaction", _TSPTaggedTx),
])

# --- operation id preimages (for claimable balance ids etc.) ---

_OperationIDId = xdr_struct("OperationIDId", [
    ("sourceAccount", AccountID),
    ("seqNum", SequenceNumber),
    ("opNum", Uint32),
])

HashIDPreimage = xdr_union("HashIDPreimage", EnvelopeType, {
    EnvelopeType.ENVELOPE_TYPE_OP_ID: ("operationID", _OperationIDId),
})

# --- results ---

TransactionResultCode = xdr_enum("TransactionResultCode", {
    "txFEE_BUMP_INNER_SUCCESS": 1,
    "txSUCCESS": 0,
    "txFAILED": -1,
    "txTOO_EARLY": -2,
    "txTOO_LATE": -3,
    "txMISSING_OPERATION": -4,
    "txBAD_SEQ": -5,
    "txBAD_AUTH": -6,
    "txINSUFFICIENT_BALANCE": -7,
    "txNO_ACCOUNT": -8,
    "txINSUFFICIENT_FEE": -9,
    "txBAD_AUTH_EXTRA": -10,
    "txINTERNAL_ERROR": -11,
    "txNOT_SUPPORTED": -12,
    "txFEE_BUMP_INNER_FAILED": -13,
    "txBAD_SPONSORSHIP": -14,
    "txBAD_MIN_SEQ_AGE_OR_GAP": -15,
    "txMALFORMED": -16,
    "txSOROBAN_INVALID": -17,
})

OperationResultCode = xdr_enum("OperationResultCode", {
    "opINNER": 0,
    "opBAD_AUTH": -1,
    "opNO_ACCOUNT": -2,
    "opNOT_SUPPORTED": -3,
    "opTOO_MANY_SUBENTRIES": -4,
    "opEXCEEDED_WORK_LIMIT": -5,
    "opTOO_MANY_SPONSORING": -6,
})


def _simple_result(name: str, codes: dict, success_arms: dict = None):
    """Most op results are enum + void arms (success sometimes carries data)."""
    enum_t = xdr_enum(name + "Code", codes)
    arms = {}
    for cname, cval in codes.items():
        payload = (success_arms or {}).get(cval)
        arms[enum_t(cval)] = (cname, payload)
    return enum_t, xdr_union(name, enum_t, arms, default=("unknown", None))


CreateAccountResultCode, CreateAccountResult = _simple_result(
    "CreateAccountResult", {
        "CREATE_ACCOUNT_SUCCESS": 0,
        "CREATE_ACCOUNT_MALFORMED": -1,
        "CREATE_ACCOUNT_UNDERFUNDED": -2,
        "CREATE_ACCOUNT_LOW_RESERVE": -3,
        "CREATE_ACCOUNT_ALREADY_EXIST": -4,
    })

PaymentResultCode, PaymentResult = _simple_result(
    "PaymentResult", {
        "PAYMENT_SUCCESS": 0,
        "PAYMENT_MALFORMED": -1,
        "PAYMENT_UNDERFUNDED": -2,
        "PAYMENT_SRC_NO_TRUST": -3,
        "PAYMENT_SRC_NOT_AUTHORIZED": -4,
        "PAYMENT_NO_DESTINATION": -5,
        "PAYMENT_NO_TRUST": -6,
        "PAYMENT_NOT_AUTHORIZED": -7,
        "PAYMENT_LINE_FULL": -8,
        "PAYMENT_NO_ISSUER": -9,
    })

# Offer results carry structured success payloads.
ClaimAtomType = xdr_enum("ClaimAtomType", {
    "CLAIM_ATOM_TYPE_V0": 0,
    "CLAIM_ATOM_TYPE_ORDER_BOOK": 1,
    "CLAIM_ATOM_TYPE_LIQUIDITY_POOL": 2,
})

ClaimOfferAtomV0 = xdr_struct("ClaimOfferAtomV0", [
    ("sellerEd25519", Uint256),
    ("offerID", Int64),
    ("assetSold", Asset),
    ("amountSold", Int64),
    ("assetBought", Asset),
    ("amountBought", Int64),
])

ClaimOfferAtom = xdr_struct("ClaimOfferAtom", [
    ("sellerID", AccountID),
    ("offerID", Int64),
    ("assetSold", Asset),
    ("amountSold", Int64),
    ("assetBought", Asset),
    ("amountBought", Int64),
])

ClaimLiquidityAtom = xdr_struct("ClaimLiquidityAtom", [
    ("liquidityPoolID", PoolID),
    ("assetSold", Asset),
    ("amountSold", Int64),
    ("assetBought", Asset),
    ("amountBought", Int64),
])

ClaimAtom = xdr_union("ClaimAtom", ClaimAtomType, {
    ClaimAtomType.CLAIM_ATOM_TYPE_V0: ("v0", ClaimOfferAtomV0),
    ClaimAtomType.CLAIM_ATOM_TYPE_ORDER_BOOK: ("orderBook", ClaimOfferAtom),
    ClaimAtomType.CLAIM_ATOM_TYPE_LIQUIDITY_POOL: ("liquidityPool", ClaimLiquidityAtom),
})

ManageOfferEffect = xdr_enum("ManageOfferEffect", {
    "MANAGE_OFFER_CREATED": 0,
    "MANAGE_OFFER_UPDATED": 1,
    "MANAGE_OFFER_DELETED": 2,
})

_ManageOfferSuccessOffer = xdr_union("ManageOfferSuccessResultOffer", ManageOfferEffect, {
    ManageOfferEffect.MANAGE_OFFER_CREATED: ("offer", OfferEntry),
    ManageOfferEffect.MANAGE_OFFER_UPDATED: ("offer_updated", OfferEntry),
    ManageOfferEffect.MANAGE_OFFER_DELETED: ("deleted", None),
})

ManageOfferSuccessResult = xdr_struct("ManageOfferSuccessResult", [
    ("offersClaimed", VarArray(ClaimAtom)),
    ("offer", _ManageOfferSuccessOffer),
])

ManageSellOfferResultCode = xdr_enum("ManageSellOfferResultCode", {
    "MANAGE_SELL_OFFER_SUCCESS": 0,
    "MANAGE_SELL_OFFER_MALFORMED": -1,
    "MANAGE_SELL_OFFER_SELL_NO_TRUST": -2,
    "MANAGE_SELL_OFFER_BUY_NO_TRUST": -3,
    "MANAGE_SELL_OFFER_SELL_NOT_AUTHORIZED": -4,
    "MANAGE_SELL_OFFER_BUY_NOT_AUTHORIZED": -5,
    "MANAGE_SELL_OFFER_LINE_FULL": -6,
    "MANAGE_SELL_OFFER_UNDERFUNDED": -7,
    "MANAGE_SELL_OFFER_CROSS_SELF": -8,
    "MANAGE_SELL_OFFER_SELL_NO_ISSUER": -9,
    "MANAGE_SELL_OFFER_BUY_NO_ISSUER": -10,
    "MANAGE_SELL_OFFER_NOT_FOUND": -11,
    "MANAGE_SELL_OFFER_LOW_RESERVE": -12,
})

ManageSellOfferResult = xdr_union("ManageSellOfferResult", ManageSellOfferResultCode, {
    ManageSellOfferResultCode.MANAGE_SELL_OFFER_SUCCESS:
        ("success", ManageOfferSuccessResult),
}, default=("failed", None))

ManageBuyOfferResultCode = xdr_enum("ManageBuyOfferResultCode", {
    "MANAGE_BUY_OFFER_SUCCESS": 0,
    "MANAGE_BUY_OFFER_MALFORMED": -1,
    "MANAGE_BUY_OFFER_SELL_NO_TRUST": -2,
    "MANAGE_BUY_OFFER_BUY_NO_TRUST": -3,
    "MANAGE_BUY_OFFER_SELL_NOT_AUTHORIZED": -4,
    "MANAGE_BUY_OFFER_BUY_NOT_AUTHORIZED": -5,
    "MANAGE_BUY_OFFER_LINE_FULL": -6,
    "MANAGE_BUY_OFFER_UNDERFUNDED": -7,
    "MANAGE_BUY_OFFER_CROSS_SELF": -8,
    "MANAGE_BUY_OFFER_SELL_NO_ISSUER": -9,
    "MANAGE_BUY_OFFER_BUY_NO_ISSUER": -10,
    "MANAGE_BUY_OFFER_NOT_FOUND": -11,
    "MANAGE_BUY_OFFER_LOW_RESERVE": -12,
})

ManageBuyOfferResult = xdr_union("ManageBuyOfferResult", ManageBuyOfferResultCode, {
    ManageBuyOfferResultCode.MANAGE_BUY_OFFER_SUCCESS:
        ("success", ManageOfferSuccessResult),
}, default=("failed", None))

SetOptionsResultCode, SetOptionsResult = _simple_result(
    "SetOptionsResult", {
        "SET_OPTIONS_SUCCESS": 0,
        "SET_OPTIONS_LOW_RESERVE": -1,
        "SET_OPTIONS_TOO_MANY_SIGNERS": -2,
        "SET_OPTIONS_BAD_FLAGS": -3,
        "SET_OPTIONS_INVALID_INFLATION": -4,
        "SET_OPTIONS_CANT_CHANGE": -5,
        "SET_OPTIONS_UNKNOWN_FLAG": -6,
        "SET_OPTIONS_THRESHOLD_OUT_OF_RANGE": -7,
        "SET_OPTIONS_BAD_SIGNER": -8,
        "SET_OPTIONS_INVALID_HOME_DOMAIN": -9,
        "SET_OPTIONS_AUTH_REVOCABLE_REQUIRED": -10,
    })

ChangeTrustResultCode, ChangeTrustResult = _simple_result(
    "ChangeTrustResult", {
        "CHANGE_TRUST_SUCCESS": 0,
        "CHANGE_TRUST_MALFORMED": -1,
        "CHANGE_TRUST_NO_ISSUER": -2,
        "CHANGE_TRUST_INVALID_LIMIT": -3,
        "CHANGE_TRUST_LOW_RESERVE": -4,
        "CHANGE_TRUST_SELF_NOT_ALLOWED": -5,
        "CHANGE_TRUST_TRUST_LINE_MISSING": -6,
        "CHANGE_TRUST_CANNOT_DELETE": -7,
        "CHANGE_TRUST_NOT_AUTH_MAINTAIN_LIABILITIES": -8,
    })

AllowTrustResultCode, AllowTrustResult = _simple_result(
    "AllowTrustResult", {
        "ALLOW_TRUST_SUCCESS": 0,
        "ALLOW_TRUST_MALFORMED": -1,
        "ALLOW_TRUST_NO_TRUST_LINE": -2,
        "ALLOW_TRUST_TRUST_NOT_REQUIRED": -3,
        "ALLOW_TRUST_CANT_REVOKE": -4,
        "ALLOW_TRUST_SELF_NOT_ALLOWED": -5,
        "ALLOW_TRUST_LOW_RESERVE": -6,
    })

AccountMergeResultCode = xdr_enum("AccountMergeResultCode", {
    "ACCOUNT_MERGE_SUCCESS": 0,
    "ACCOUNT_MERGE_MALFORMED": -1,
    "ACCOUNT_MERGE_NO_ACCOUNT": -2,
    "ACCOUNT_MERGE_IMMUTABLE_SET": -3,
    "ACCOUNT_MERGE_HAS_SUB_ENTRIES": -4,
    "ACCOUNT_MERGE_SEQNUM_TOO_FAR": -5,
    "ACCOUNT_MERGE_DEST_FULL": -6,
    "ACCOUNT_MERGE_IS_SPONSOR": -7,
})

AccountMergeResult = xdr_union("AccountMergeResult", AccountMergeResultCode, {
    AccountMergeResultCode.ACCOUNT_MERGE_SUCCESS: ("sourceAccountBalance", Int64),
}, default=("failed", None))

InflationPayout = xdr_struct("InflationPayout", [
    ("destination", AccountID),
    ("amount", Int64),
])

InflationResultCode = xdr_enum("InflationResultCode", {
    "INFLATION_SUCCESS": 0,
    "INFLATION_NOT_TIME": -1,
})

InflationResult = xdr_union("InflationResult", InflationResultCode, {
    InflationResultCode.INFLATION_SUCCESS: ("payouts", VarArray(InflationPayout)),
}, default=("failed", None))

ManageDataResultCode, ManageDataResult = _simple_result(
    "ManageDataResult", {
        "MANAGE_DATA_SUCCESS": 0,
        "MANAGE_DATA_NOT_SUPPORTED_YET": -1,
        "MANAGE_DATA_NAME_NOT_FOUND": -2,
        "MANAGE_DATA_LOW_RESERVE": -3,
        "MANAGE_DATA_INVALID_NAME": -4,
    })

BumpSequenceResultCode, BumpSequenceResult = _simple_result(
    "BumpSequenceResult", {
        "BUMP_SEQUENCE_SUCCESS": 0,
        "BUMP_SEQUENCE_BAD_SEQ": -1,
    })

PathPaymentStrictReceiveResultCode = xdr_enum("PathPaymentStrictReceiveResultCode", {
    "PATH_PAYMENT_STRICT_RECEIVE_SUCCESS": 0,
    "PATH_PAYMENT_STRICT_RECEIVE_MALFORMED": -1,
    "PATH_PAYMENT_STRICT_RECEIVE_UNDERFUNDED": -2,
    "PATH_PAYMENT_STRICT_RECEIVE_SRC_NO_TRUST": -3,
    "PATH_PAYMENT_STRICT_RECEIVE_SRC_NOT_AUTHORIZED": -4,
    "PATH_PAYMENT_STRICT_RECEIVE_NO_DESTINATION": -5,
    "PATH_PAYMENT_STRICT_RECEIVE_NO_TRUST": -6,
    "PATH_PAYMENT_STRICT_RECEIVE_NOT_AUTHORIZED": -7,
    "PATH_PAYMENT_STRICT_RECEIVE_LINE_FULL": -8,
    "PATH_PAYMENT_STRICT_RECEIVE_NO_ISSUER": -9,
    "PATH_PAYMENT_STRICT_RECEIVE_TOO_FEW_OFFERS": -10,
    "PATH_PAYMENT_STRICT_RECEIVE_OFFER_CROSS_SELF": -11,
    "PATH_PAYMENT_STRICT_RECEIVE_OVER_SENDMAX": -12,
})

SimplePaymentResult = xdr_struct("SimplePaymentResult", [
    ("destination", AccountID),
    ("asset", Asset),
    ("amount", Int64),
])

_PPSRSuccess = xdr_struct("PathPaymentStrictReceiveResultSuccess", [
    ("offers", VarArray(ClaimAtom)),
    ("last", SimplePaymentResult),
])

PathPaymentStrictReceiveResult = xdr_union(
    "PathPaymentStrictReceiveResult", PathPaymentStrictReceiveResultCode, {
        PathPaymentStrictReceiveResultCode.PATH_PAYMENT_STRICT_RECEIVE_SUCCESS:
            ("success", _PPSRSuccess),
        PathPaymentStrictReceiveResultCode.PATH_PAYMENT_STRICT_RECEIVE_NO_ISSUER:
            ("noIssuer", Asset),
    }, default=("failed", None))

PathPaymentStrictSendResultCode = xdr_enum("PathPaymentStrictSendResultCode", {
    "PATH_PAYMENT_STRICT_SEND_SUCCESS": 0,
    "PATH_PAYMENT_STRICT_SEND_MALFORMED": -1,
    "PATH_PAYMENT_STRICT_SEND_UNDERFUNDED": -2,
    "PATH_PAYMENT_STRICT_SEND_SRC_NO_TRUST": -3,
    "PATH_PAYMENT_STRICT_SEND_SRC_NOT_AUTHORIZED": -4,
    "PATH_PAYMENT_STRICT_SEND_NO_DESTINATION": -5,
    "PATH_PAYMENT_STRICT_SEND_NO_TRUST": -6,
    "PATH_PAYMENT_STRICT_SEND_NOT_AUTHORIZED": -7,
    "PATH_PAYMENT_STRICT_SEND_LINE_FULL": -8,
    "PATH_PAYMENT_STRICT_SEND_NO_ISSUER": -9,
    "PATH_PAYMENT_STRICT_SEND_TOO_FEW_OFFERS": -10,
    "PATH_PAYMENT_STRICT_SEND_OFFER_CROSS_SELF": -11,
    "PATH_PAYMENT_STRICT_SEND_UNDER_DESTMIN": -12,
})

_PPSSSuccess = xdr_struct("PathPaymentStrictSendResultSuccess", [
    ("offers", VarArray(ClaimAtom)),
    ("last", SimplePaymentResult),
])

PathPaymentStrictSendResult = xdr_union(
    "PathPaymentStrictSendResult", PathPaymentStrictSendResultCode, {
        PathPaymentStrictSendResultCode.PATH_PAYMENT_STRICT_SEND_SUCCESS:
            ("success", _PPSSSuccess),
        PathPaymentStrictSendResultCode.PATH_PAYMENT_STRICT_SEND_NO_ISSUER:
            ("noIssuer", Asset),
    }, default=("failed", None))

CreateClaimableBalanceResultCode = xdr_enum("CreateClaimableBalanceResultCode", {
    "CREATE_CLAIMABLE_BALANCE_SUCCESS": 0,
    "CREATE_CLAIMABLE_BALANCE_MALFORMED": -1,
    "CREATE_CLAIMABLE_BALANCE_LOW_RESERVE": -2,
    "CREATE_CLAIMABLE_BALANCE_NO_TRUST": -3,
    "CREATE_CLAIMABLE_BALANCE_NOT_AUTHORIZED": -4,
    "CREATE_CLAIMABLE_BALANCE_UNDERFUNDED": -5,
})

CreateClaimableBalanceResult = xdr_union(
    "CreateClaimableBalanceResult", CreateClaimableBalanceResultCode, {
        CreateClaimableBalanceResultCode.CREATE_CLAIMABLE_BALANCE_SUCCESS:
            ("balanceID", ClaimableBalanceID),
    }, default=("failed", None))

ClaimClaimableBalanceResultCode, ClaimClaimableBalanceResult = _simple_result(
    "ClaimClaimableBalanceResult", {
        "CLAIM_CLAIMABLE_BALANCE_SUCCESS": 0,
        "CLAIM_CLAIMABLE_BALANCE_DOES_NOT_EXIST": -1,
        "CLAIM_CLAIMABLE_BALANCE_CANNOT_CLAIM": -2,
        "CLAIM_CLAIMABLE_BALANCE_LINE_FULL": -3,
        "CLAIM_CLAIMABLE_BALANCE_NO_TRUST": -4,
        "CLAIM_CLAIMABLE_BALANCE_NOT_AUTHORIZED": -5,
    })

BeginSponsoringFutureReservesResultCode, BeginSponsoringFutureReservesResult = \
    _simple_result("BeginSponsoringFutureReservesResult", {
        "BEGIN_SPONSORING_FUTURE_RESERVES_SUCCESS": 0,
        "BEGIN_SPONSORING_FUTURE_RESERVES_MALFORMED": -1,
        "BEGIN_SPONSORING_FUTURE_RESERVES_ALREADY_SPONSORED": -2,
        "BEGIN_SPONSORING_FUTURE_RESERVES_RECURSIVE": -3,
    })

EndSponsoringFutureReservesResultCode, EndSponsoringFutureReservesResult = \
    _simple_result("EndSponsoringFutureReservesResult", {
        "END_SPONSORING_FUTURE_RESERVES_SUCCESS": 0,
        "END_SPONSORING_FUTURE_RESERVES_NOT_SPONSORED": -1,
    })

RevokeSponsorshipResultCode, RevokeSponsorshipResult = _simple_result(
    "RevokeSponsorshipResult", {
        "REVOKE_SPONSORSHIP_SUCCESS": 0,
        "REVOKE_SPONSORSHIP_DOES_NOT_EXIST": -1,
        "REVOKE_SPONSORSHIP_NOT_SPONSOR": -2,
        "REVOKE_SPONSORSHIP_LOW_RESERVE": -3,
        "REVOKE_SPONSORSHIP_ONLY_TRANSFERABLE": -4,
        "REVOKE_SPONSORSHIP_MALFORMED": -5,
    })

ClawbackResultCode, ClawbackResult = _simple_result(
    "ClawbackResult", {
        "CLAWBACK_SUCCESS": 0,
        "CLAWBACK_MALFORMED": -1,
        "CLAWBACK_NOT_CLAWBACK_ENABLED": -2,
        "CLAWBACK_NO_TRUST": -3,
        "CLAWBACK_UNDERFUNDED": -4,
    })

ClawbackClaimableBalanceResultCode, ClawbackClaimableBalanceResult = _simple_result(
    "ClawbackClaimableBalanceResult", {
        "CLAWBACK_CLAIMABLE_BALANCE_SUCCESS": 0,
        "CLAWBACK_CLAIMABLE_BALANCE_DOES_NOT_EXIST": -1,
        "CLAWBACK_CLAIMABLE_BALANCE_NOT_ISSUER": -2,
        "CLAWBACK_CLAIMABLE_BALANCE_NOT_CLAWBACK_ENABLED": -3,
    })

SetTrustLineFlagsResultCode, SetTrustLineFlagsResult = _simple_result(
    "SetTrustLineFlagsResult", {
        "SET_TRUST_LINE_FLAGS_SUCCESS": 0,
        "SET_TRUST_LINE_FLAGS_MALFORMED": -1,
        "SET_TRUST_LINE_FLAGS_NO_TRUST_LINE": -2,
        "SET_TRUST_LINE_FLAGS_CANT_REVOKE": -3,
        "SET_TRUST_LINE_FLAGS_INVALID_STATE": -4,
        "SET_TRUST_LINE_FLAGS_LOW_RESERVE": -5,
    })

LiquidityPoolDepositResultCode, LiquidityPoolDepositResult = _simple_result(
    "LiquidityPoolDepositResult", {
        "LIQUIDITY_POOL_DEPOSIT_SUCCESS": 0,
        "LIQUIDITY_POOL_DEPOSIT_MALFORMED": -1,
        "LIQUIDITY_POOL_DEPOSIT_NO_TRUST": -2,
        "LIQUIDITY_POOL_DEPOSIT_NOT_AUTHORIZED": -3,
        "LIQUIDITY_POOL_DEPOSIT_UNDERFUNDED": -4,
        "LIQUIDITY_POOL_DEPOSIT_LINE_FULL": -5,
        "LIQUIDITY_POOL_DEPOSIT_BAD_PRICE": -6,
        "LIQUIDITY_POOL_DEPOSIT_POOL_FULL": -7,
    })

LiquidityPoolWithdrawResultCode, LiquidityPoolWithdrawResult = _simple_result(
    "LiquidityPoolWithdrawResult", {
        "LIQUIDITY_POOL_WITHDRAW_SUCCESS": 0,
        "LIQUIDITY_POOL_WITHDRAW_MALFORMED": -1,
        "LIQUIDITY_POOL_WITHDRAW_NO_TRUST": -2,
        "LIQUIDITY_POOL_WITHDRAW_UNDERFUNDED": -3,
        "LIQUIDITY_POOL_WITHDRAW_LINE_FULL": -4,
        "LIQUIDITY_POOL_WITHDRAW_UNDER_MINIMUM": -5,
    })

InvokeHostFunctionResultCode, InvokeHostFunctionResult = _simple_result(
    "InvokeHostFunctionResult", {
        "INVOKE_HOST_FUNCTION_SUCCESS": 0,
        "INVOKE_HOST_FUNCTION_MALFORMED": -1,
        "INVOKE_HOST_FUNCTION_TRAPPED": -2,
        "INVOKE_HOST_FUNCTION_RESOURCE_LIMIT_EXCEEDED": -3,
        "INVOKE_HOST_FUNCTION_ENTRY_ARCHIVED": -4,
        "INVOKE_HOST_FUNCTION_INSUFFICIENT_REFUNDABLE_FEE": -5,
    }, success_arms={0: Hash})

ExtendFootprintTTLResultCode, ExtendFootprintTTLResult = _simple_result(
    "ExtendFootprintTTLResult", {
        "EXTEND_FOOTPRINT_TTL_SUCCESS": 0,
        "EXTEND_FOOTPRINT_TTL_MALFORMED": -1,
        "EXTEND_FOOTPRINT_TTL_RESOURCE_LIMIT_EXCEEDED": -2,
        "EXTEND_FOOTPRINT_TTL_INSUFFICIENT_REFUNDABLE_FEE": -3,
    })

RestoreFootprintResultCode, RestoreFootprintResult = _simple_result(
    "RestoreFootprintResult", {
        "RESTORE_FOOTPRINT_SUCCESS": 0,
        "RESTORE_FOOTPRINT_MALFORMED": -1,
        "RESTORE_FOOTPRINT_RESOURCE_LIMIT_EXCEEDED": -2,
        "RESTORE_FOOTPRINT_INSUFFICIENT_REFUNDABLE_FEE": -3,
    })

_OpResultTr = xdr_union("OperationResultTr", OperationType, {
    OperationType.CREATE_ACCOUNT: ("createAccountResult", CreateAccountResult),
    OperationType.PAYMENT: ("paymentResult", PaymentResult),
    OperationType.PATH_PAYMENT_STRICT_RECEIVE:
        ("pathPaymentStrictReceiveResult", PathPaymentStrictReceiveResult),
    OperationType.MANAGE_SELL_OFFER: ("manageSellOfferResult", ManageSellOfferResult),
    OperationType.CREATE_PASSIVE_SELL_OFFER:
        ("createPassiveSellOfferResult", ManageSellOfferResult),
    OperationType.SET_OPTIONS: ("setOptionsResult", SetOptionsResult),
    OperationType.CHANGE_TRUST: ("changeTrustResult", ChangeTrustResult),
    OperationType.ALLOW_TRUST: ("allowTrustResult", AllowTrustResult),
    OperationType.ACCOUNT_MERGE: ("accountMergeResult", AccountMergeResult),
    OperationType.INFLATION: ("inflationResult", InflationResult),
    OperationType.MANAGE_DATA: ("manageDataResult", ManageDataResult),
    OperationType.BUMP_SEQUENCE: ("bumpSeqResult", BumpSequenceResult),
    OperationType.MANAGE_BUY_OFFER: ("manageBuyOfferResult", ManageBuyOfferResult),
    OperationType.PATH_PAYMENT_STRICT_SEND:
        ("pathPaymentStrictSendResult", PathPaymentStrictSendResult),
    OperationType.CREATE_CLAIMABLE_BALANCE:
        ("createClaimableBalanceResult", CreateClaimableBalanceResult),
    OperationType.CLAIM_CLAIMABLE_BALANCE:
        ("claimClaimableBalanceResult", ClaimClaimableBalanceResult),
    OperationType.BEGIN_SPONSORING_FUTURE_RESERVES:
        ("beginSponsoringFutureReservesResult", BeginSponsoringFutureReservesResult),
    OperationType.END_SPONSORING_FUTURE_RESERVES:
        ("endSponsoringFutureReservesResult", EndSponsoringFutureReservesResult),
    OperationType.REVOKE_SPONSORSHIP:
        ("revokeSponsorshipResult", RevokeSponsorshipResult),
    OperationType.CLAWBACK: ("clawbackResult", ClawbackResult),
    OperationType.CLAWBACK_CLAIMABLE_BALANCE:
        ("clawbackClaimableBalanceResult", ClawbackClaimableBalanceResult),
    OperationType.SET_TRUST_LINE_FLAGS:
        ("setTrustLineFlagsResult", SetTrustLineFlagsResult),
    OperationType.LIQUIDITY_POOL_DEPOSIT:
        ("liquidityPoolDepositResult", LiquidityPoolDepositResult),
    OperationType.LIQUIDITY_POOL_WITHDRAW:
        ("liquidityPoolWithdrawResult", LiquidityPoolWithdrawResult),
    OperationType.INVOKE_HOST_FUNCTION:
        ("invokeHostFunctionResult", InvokeHostFunctionResult),
    OperationType.EXTEND_FOOTPRINT_TTL:
        ("extendFootprintTTLResult", ExtendFootprintTTLResult),
    OperationType.RESTORE_FOOTPRINT:
        ("restoreFootprintResult", RestoreFootprintResult),
})

OperationResultTr = _OpResultTr

OperationResult = xdr_union("OperationResult", OperationResultCode, {
    OperationResultCode.opINNER: ("tr", _OpResultTr),
}, default=("failed", None))

_InnerTransactionResultResult = xdr_union(
    "InnerTransactionResultResult", TransactionResultCode, {
        TransactionResultCode.txSUCCESS: ("results", VarArray(OperationResult)),
        TransactionResultCode.txFAILED: ("results_failed", VarArray(OperationResult)),
    }, default=("void", None))

InnerTransactionResultExt = xdr_union("InnerTransactionResultExt", Int32,
                                      {0: ("v0", None)})

InnerTransactionResult = xdr_struct("InnerTransactionResult", [
    ("feeCharged", Int64),
    ("result", _InnerTransactionResultResult),
    ("ext", InnerTransactionResultExt),
], defaults={"ext": lambda: InnerTransactionResultExt.v0()})

InnerTransactionResultPair = xdr_struct("InnerTransactionResultPair", [
    ("transactionHash", Hash),
    ("result", InnerTransactionResult),
])

TransactionResultResult = xdr_union(
    "TransactionResultResult", TransactionResultCode, {
        TransactionResultCode.txFEE_BUMP_INNER_SUCCESS:
            ("innerResultPair", InnerTransactionResultPair),
        TransactionResultCode.txFEE_BUMP_INNER_FAILED:
            ("innerResultPair_failed", InnerTransactionResultPair),
        TransactionResultCode.txSUCCESS: ("results", VarArray(OperationResult)),
        TransactionResultCode.txFAILED: ("results_failed", VarArray(OperationResult)),
    }, default=("void", None))

TransactionResultExt = xdr_union("TransactionResultExt", Int32, {0: ("v0", None)})

TransactionResult = xdr_struct("TransactionResult", [
    ("feeCharged", Int64),
    ("result", TransactionResultResult),
    ("ext", TransactionResultExt),
], defaults={"ext": lambda: TransactionResultExt.v0()})

TransactionResultPair = xdr_struct("TransactionResultPair", [
    ("transactionHash", Hash),
    ("result", TransactionResult),
])


# public aliases (used by the transaction frames)
TransactionSignaturePayloadTaggedTransaction = _TSPTaggedTx
InnerTransactionResultResult = _InnerTransactionResultResult
FeeBumpInnerTx = _FeeBumpInnerTx
ManageOfferSuccessResultOffer = _ManageOfferSuccessOffer
PathPaymentStrictReceiveResultSuccess = _PPSRSuccess
PathPaymentStrictSendResultSuccess = _PPSSSuccess
OperationIDId = _OperationIDId
RevokeSponsorshipOpSigner = _RevokeSponsorshipSigner
