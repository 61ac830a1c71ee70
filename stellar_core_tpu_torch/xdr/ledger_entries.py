"""Stellar-ledger-entries.x equivalents (reference:
src/protocol-curr/xdr/Stellar-ledger-entries.x): assets, the six classic
ledger-entry types (+ Soroban contract data/code, config, TTL), LedgerEntry,
LedgerKey."""

from .codec import (Bool, Int32, Int64, Opaque, Optional, Uint32, Uint64,
                    VarArray, VarOpaque, Void, XdrString, xdr_enum, xdr_struct,
                    xdr_union)
from .types import (AccountID, AssetCode4, AssetCode12, DataValue, ExtensionPoint,
                    Hash, Liabilities, PoolID, Price, SequenceNumber, SignerKey,
                    String32, String64, Thresholds, TimePoint, Uint256)

MASK_ACCOUNT_FLAGS_V17 = 0xF
MAX_SIGNERS = 20

AssetType = xdr_enum("AssetType", {
    "ASSET_TYPE_NATIVE": 0,
    "ASSET_TYPE_CREDIT_ALPHANUM4": 1,
    "ASSET_TYPE_CREDIT_ALPHANUM12": 2,
    "ASSET_TYPE_POOL_SHARE": 3,
})

AlphaNum4 = xdr_struct("AlphaNum4", [
    ("assetCode", AssetCode4),
    ("issuer", AccountID),
])

AlphaNum12 = xdr_struct("AlphaNum12", [
    ("assetCode", AssetCode12),
    ("issuer", AccountID),
])

Asset = xdr_union("Asset", AssetType, {
    AssetType.ASSET_TYPE_NATIVE: ("native", None),
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: ("alphaNum4", AlphaNum4),
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: ("alphaNum12", AlphaNum12),
})

TrustLineAsset = xdr_union("TrustLineAsset", AssetType, {
    AssetType.ASSET_TYPE_NATIVE: ("native", None),
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: ("alphaNum4", AlphaNum4),
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: ("alphaNum12", AlphaNum12),
    AssetType.ASSET_TYPE_POOL_SHARE: ("liquidityPoolID", PoolID),
})

LedgerEntryType = xdr_enum("LedgerEntryType", {
    "ACCOUNT": 0,
    "TRUSTLINE": 1,
    "OFFER": 2,
    "DATA": 3,
    "CLAIMABLE_BALANCE": 4,
    "LIQUIDITY_POOL": 5,
    "CONTRACT_DATA": 6,
    "CONTRACT_CODE": 7,
    "CONFIG_SETTING": 8,
    "TTL": 9,
})

Signer = xdr_struct("Signer", [
    ("key", SignerKey),
    ("weight", Uint32),
])

AccountFlags = xdr_enum("AccountFlags", {
    "AUTH_REQUIRED_FLAG": 0x1,
    "AUTH_REVOCABLE_FLAG": 0x2,
    "AUTH_IMMUTABLE_FLAG": 0x4,
    "AUTH_CLAWBACK_ENABLED_FLAG": 0x8,
})

SponsorshipDescriptor = Optional(AccountID)

AccountEntryExtensionV3 = xdr_struct("AccountEntryExtensionV3", [
    ("ext", ExtensionPoint),
    ("seqLedger", Uint32),
    ("seqTime", TimePoint),
], defaults={"ext": lambda: ExtensionPoint.v0()})

AccountEntryExtensionV2Ext = xdr_union("AccountEntryExtensionV2Ext", Int32, {
    0: ("v0", None),
    3: ("v3", AccountEntryExtensionV3),
})

AccountEntryExtensionV2 = xdr_struct("AccountEntryExtensionV2", [
    ("numSponsored", Uint32),
    ("numSponsoring", Uint32),
    ("signerSponsoringIDs", VarArray(SponsorshipDescriptor, MAX_SIGNERS)),
    ("ext", AccountEntryExtensionV2Ext),
], defaults={"numSponsored": 0, "numSponsoring": 0, "signerSponsoringIDs": list,
             "ext": lambda: AccountEntryExtensionV2Ext.v0()})

AccountEntryExtensionV1Ext = xdr_union("AccountEntryExtensionV1Ext", Int32, {
    0: ("v0", None),
    2: ("v2", AccountEntryExtensionV2),
})

AccountEntryExtensionV1 = xdr_struct("AccountEntryExtensionV1", [
    ("liabilities", Liabilities),
    ("ext", AccountEntryExtensionV1Ext),
], defaults={"ext": lambda: AccountEntryExtensionV1Ext.v0()})

AccountEntryExt = xdr_union("AccountEntryExt", Int32, {
    0: ("v0", None),
    1: ("v1", AccountEntryExtensionV1),
})

AccountEntry = xdr_struct("AccountEntry", [
    ("accountID", AccountID),
    ("balance", Int64),
    ("seqNum", SequenceNumber),
    ("numSubEntries", Uint32),
    ("inflationDest", Optional(AccountID)),
    ("flags", Uint32),
    ("homeDomain", String32),
    ("thresholds", Thresholds),
    ("signers", VarArray(Signer, MAX_SIGNERS)),
    ("ext", AccountEntryExt),
], defaults={
    "numSubEntries": 0, "inflationDest": None, "flags": 0,
    "homeDomain": b"", "thresholds": b"\x01\x00\x00\x00",
    "signers": list, "ext": lambda: AccountEntryExt.v0(),
})

TrustLineFlags = xdr_enum("TrustLineFlags", {
    "AUTHORIZED_FLAG": 1,
    "AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG": 2,
    "TRUSTLINE_CLAWBACK_ENABLED_FLAG": 4,
})

_TLEv2Ext = xdr_union("TrustLineEntryExtensionV2Ext", Int32, {0: ("v0", None)})

TrustLineEntryExtensionV2 = xdr_struct("TrustLineEntryExtensionV2", [
    ("liquidityPoolUseCount", Int32),
    ("ext", _TLEv2Ext),
], defaults={"liquidityPoolUseCount": 0, "ext": lambda: _TLEv2Ext.v0()})

TrustLineEntryV1Ext = xdr_union("TrustLineEntryV1Ext", Int32, {
    0: ("v0", None),
    2: ("v2", TrustLineEntryExtensionV2),
})

TrustLineEntryV1 = xdr_struct("TrustLineEntryV1", [
    ("liabilities", Liabilities),
    ("ext", TrustLineEntryV1Ext),
], defaults={"ext": lambda: TrustLineEntryV1Ext.v0()})

TrustLineEntryExt = xdr_union("TrustLineEntryExt", Int32, {
    0: ("v0", None),
    1: ("v1", TrustLineEntryV1),
})

TrustLineEntry = xdr_struct("TrustLineEntry", [
    ("accountID", AccountID),
    ("asset", TrustLineAsset),
    ("balance", Int64),
    ("limit", Int64),
    ("flags", Uint32),
    ("ext", TrustLineEntryExt),
], defaults={"balance": 0, "flags": 0, "ext": lambda: TrustLineEntryExt.v0()})

OfferEntryFlags = xdr_enum("OfferEntryFlags", {"PASSIVE_FLAG": 1})

_OfferEntryExt = xdr_union("OfferEntryExt", Int32, {0: ("v0", None)})

OfferEntry = xdr_struct("OfferEntry", [
    ("sellerID", AccountID),
    ("offerID", Int64),
    ("selling", Asset),
    ("buying", Asset),
    ("amount", Int64),
    ("price", Price),
    ("flags", Uint32),
    ("ext", _OfferEntryExt),
], defaults={"flags": 0, "ext": lambda: _OfferEntryExt.v0()})

_DataEntryExt = xdr_union("DataEntryExt", Int32, {0: ("v0", None)})

DataEntry = xdr_struct("DataEntry", [
    ("accountID", AccountID),
    ("dataName", String64),
    ("dataValue", DataValue),
    ("ext", _DataEntryExt),
], defaults={"ext": lambda: _DataEntryExt.v0()})

ClaimPredicateType = xdr_enum("ClaimPredicateType", {
    "CLAIM_PREDICATE_UNCONDITIONAL": 0,
    "CLAIM_PREDICATE_AND": 1,
    "CLAIM_PREDICATE_OR": 2,
    "CLAIM_PREDICATE_NOT": 3,
    "CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME": 4,
    "CLAIM_PREDICATE_BEFORE_RELATIVE_TIME": 5,
})


from .codec import XdrType as _XdrType  # noqa: E402


class _ClaimPredicateFwd(_XdrType):
    """Recursive type: resolved after ClaimPredicate is defined."""
    _target = None

    def pack_into(self, val, out):
        self._target.pack_into(val, out)

    def unpack_from(self, buf, off):
        return self._target.unpack_from(buf, off)


_cp_fwd = _ClaimPredicateFwd()

ClaimPredicate = xdr_union("ClaimPredicate", ClaimPredicateType, {
    ClaimPredicateType.CLAIM_PREDICATE_UNCONDITIONAL: ("unconditional", None),
    ClaimPredicateType.CLAIM_PREDICATE_AND: ("andPredicates", VarArray(_cp_fwd, 2)),
    ClaimPredicateType.CLAIM_PREDICATE_OR: ("orPredicates", VarArray(_cp_fwd, 2)),
    ClaimPredicateType.CLAIM_PREDICATE_NOT: ("notPredicate", Optional(_cp_fwd)),
    ClaimPredicateType.CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME: ("absBefore", Int64),
    ClaimPredicateType.CLAIM_PREDICATE_BEFORE_RELATIVE_TIME: ("relBefore", Int64),
})
_ClaimPredicateFwd._target = ClaimPredicate._xdr_adapter()

ClaimantType = xdr_enum("ClaimantType", {"CLAIMANT_TYPE_V0": 0})

ClaimantV0 = xdr_struct("ClaimantV0", [
    ("destination", AccountID),
    ("predicate", ClaimPredicate),
])

Claimant = xdr_union("Claimant", ClaimantType, {
    ClaimantType.CLAIMANT_TYPE_V0: ("v0", ClaimantV0),
})

ClaimableBalanceIDType = xdr_enum("ClaimableBalanceIDType", {
    "CLAIMABLE_BALANCE_ID_TYPE_V0": 0,
})

ClaimableBalanceID = xdr_union("ClaimableBalanceID", ClaimableBalanceIDType, {
    ClaimableBalanceIDType.CLAIMABLE_BALANCE_ID_TYPE_V0: ("v0", Hash),
})

ClaimableBalanceFlags = xdr_enum("ClaimableBalanceFlags", {
    "CLAIMABLE_BALANCE_CLAWBACK_ENABLED_FLAG": 1,
})

ClaimableBalanceEntryExtensionV1Ext = xdr_union(
    "ClaimableBalanceEntryExtensionV1Ext", Int32, {0: ("v0", None)})

ClaimableBalanceEntryExtensionV1 = xdr_struct("ClaimableBalanceEntryExtensionV1", [
    ("ext", ClaimableBalanceEntryExtensionV1Ext),
    ("flags", Uint32),
], defaults={"ext": lambda: ClaimableBalanceEntryExtensionV1Ext.v0()})

ClaimableBalanceEntryExt = xdr_union("ClaimableBalanceEntryExt", Int32, {
    0: ("v0", None),
    1: ("v1", ClaimableBalanceEntryExtensionV1),
})

ClaimableBalanceEntry = xdr_struct("ClaimableBalanceEntry", [
    ("balanceID", ClaimableBalanceID),
    ("claimants", VarArray(Claimant, 10)),
    ("asset", Asset),
    ("amount", Int64),
    ("ext", ClaimableBalanceEntryExt),
], defaults={"ext": lambda: ClaimableBalanceEntryExt.v0()})

LiquidityPoolType = xdr_enum("LiquidityPoolType", {
    "LIQUIDITY_POOL_CONSTANT_PRODUCT": 0,
})

LiquidityPoolConstantProductParameters = xdr_struct(
    "LiquidityPoolConstantProductParameters", [
        ("assetA", Asset),
        ("assetB", Asset),
        ("fee", Int32),
    ])

LIQUIDITY_POOL_FEE_V18 = 30

LiquidityPoolEntryConstantProduct = xdr_struct(
    "LiquidityPoolEntryConstantProduct", [
        ("params", LiquidityPoolConstantProductParameters),
        ("reserveA", Int64),
        ("reserveB", Int64),
        ("totalPoolShares", Int64),
        ("poolSharesTrustLineCount", Int64),
    ],
    defaults={"reserveA": 0, "reserveB": 0, "totalPoolShares": 0,
              "poolSharesTrustLineCount": 0})
_LPConstantProduct = LiquidityPoolEntryConstantProduct

LiquidityPoolEntryBody = xdr_union("LiquidityPoolEntryBody", LiquidityPoolType, {
    LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT:
        ("constantProduct", _LPConstantProduct),
})

LiquidityPoolEntry = xdr_struct("LiquidityPoolEntry", [
    ("liquidityPoolID", PoolID),
    ("body", LiquidityPoolEntryBody),
])

# --- Soroban entries (storage shape only; host execution is out of scope,
# see SURVEY.md §2.4 — soroban-env-host capability gap) ---

ContractDataDurability = xdr_enum("ContractDataDurability", {
    "TEMPORARY": 0,
    "PERSISTENT": 1,
})

from .contract import SCAddress, SCVal, _AssetFwd  # noqa: E402

# tie the contract-module's Asset forward reference (ContractIDPreimage
# FROM_ASSET) now that Asset exists
_AssetFwd._target = Asset._xdr_adapter()

ContractDataEntry = xdr_struct("ContractDataEntry", [
    ("ext", ExtensionPoint),
    ("contract", SCAddress),
    ("key", SCVal),
    ("durability", ContractDataDurability),
    ("val", SCVal),
])

ContractCodeEntry = xdr_struct("ContractCodeEntry", [
    ("ext", ExtensionPoint),
    ("hash", Hash),
    ("code", VarOpaque()),
])

# Real ConfigSettingEntry is a union over ConfigSettingID with ~15 typed arms;
# until the Soroban config layer lands we keep the leading discriminant (so
# ledger keys derive correctly) and carry the body opaquely.  Same wire-compat
# caveat as the Soroban ops in transaction.py.
ConfigSettingEntry = xdr_struct("ConfigSettingEntry", [
    ("configSettingID", Int32),
    ("raw", VarOpaque()),
])

TTLEntry = xdr_struct("TTLEntry", [
    ("keyHash", Hash),
    ("liveUntilLedgerSeq", Uint32),
])

LedgerEntryData = xdr_union("LedgerEntryData", LedgerEntryType, {
    LedgerEntryType.ACCOUNT: ("account", AccountEntry),
    LedgerEntryType.TRUSTLINE: ("trustLine", TrustLineEntry),
    LedgerEntryType.OFFER: ("offer", OfferEntry),
    LedgerEntryType.DATA: ("data", DataEntry),
    LedgerEntryType.CLAIMABLE_BALANCE: ("claimableBalance", ClaimableBalanceEntry),
    LedgerEntryType.LIQUIDITY_POOL: ("liquidityPool", LiquidityPoolEntry),
    LedgerEntryType.CONTRACT_DATA: ("contractData", ContractDataEntry),
    LedgerEntryType.CONTRACT_CODE: ("contractCode", ContractCodeEntry),
    LedgerEntryType.CONFIG_SETTING: ("configSetting", ConfigSettingEntry),
    LedgerEntryType.TTL: ("ttl", TTLEntry),
})

LedgerEntryExtensionV1Ext = xdr_union("LedgerEntryExtensionV1Ext", Int32,
                                      {0: ("v0", None)})

LedgerEntryExtensionV1 = xdr_struct("LedgerEntryExtensionV1", [
    ("sponsoringID", SponsorshipDescriptor),
    ("ext", LedgerEntryExtensionV1Ext),
], defaults={"ext": lambda: LedgerEntryExtensionV1Ext.v0()})

LedgerEntryExt = xdr_union("LedgerEntryExt", Int32, {
    0: ("v0", None),
    1: ("v1", LedgerEntryExtensionV1),
})

LedgerEntry = xdr_struct("LedgerEntry", [
    ("lastModifiedLedgerSeq", Uint32),
    ("data", LedgerEntryData),
    ("ext", LedgerEntryExt),
], defaults={"lastModifiedLedgerSeq": 0, "ext": lambda: LedgerEntryExt.v0()})

# --- LedgerKey ---

_LKAccount = xdr_struct("LedgerKeyAccount", [("accountID", AccountID)])
_LKTrustLine = xdr_struct("LedgerKeyTrustLine", [
    ("accountID", AccountID), ("asset", TrustLineAsset)])
_LKOffer = xdr_struct("LedgerKeyOffer", [
    ("sellerID", AccountID), ("offerID", Int64)])
_LKData = xdr_struct("LedgerKeyData", [
    ("accountID", AccountID), ("dataName", String64)])
_LKClaimableBalance = xdr_struct("LedgerKeyClaimableBalance", [
    ("balanceID", ClaimableBalanceID)])
_LKLiquidityPool = xdr_struct("LedgerKeyLiquidityPool", [
    ("liquidityPoolID", PoolID)])
_LKContractData = xdr_struct("LedgerKeyContractData", [
    ("contract", SCAddress), ("key", SCVal),
    ("durability", ContractDataDurability)])
_LKContractCode = xdr_struct("LedgerKeyContractCode", [("hash", Hash)])
_LKConfigSetting = xdr_struct("LedgerKeyConfigSetting", [("configSettingID", Int32)])
_LKTtl = xdr_struct("LedgerKeyTtl", [("keyHash", Hash)])

LedgerKey = xdr_union("LedgerKey", LedgerEntryType, {
    LedgerEntryType.ACCOUNT: ("account", _LKAccount),
    LedgerEntryType.TRUSTLINE: ("trustLine", _LKTrustLine),
    LedgerEntryType.OFFER: ("offer", _LKOffer),
    LedgerEntryType.DATA: ("data", _LKData),
    LedgerEntryType.CLAIMABLE_BALANCE: ("claimableBalance", _LKClaimableBalance),
    LedgerEntryType.LIQUIDITY_POOL: ("liquidityPool", _LKLiquidityPool),
    LedgerEntryType.CONTRACT_DATA: ("contractData", _LKContractData),
    LedgerEntryType.CONTRACT_CODE: ("contractCode", _LKContractCode),
    LedgerEntryType.CONFIG_SETTING: ("configSetting", _LKConfigSetting),
    LedgerEntryType.TTL: ("ttl", _LKTtl),
})


def ledger_entry_key(entry: "LedgerEntry") -> "LedgerKey":
    """Derive the LedgerKey identifying a LedgerEntry (reference:
    src/ledger/LedgerTxn.cpp — LedgerEntryKey)."""
    d = entry.data
    t = d.switch
    if t == LedgerEntryType.ACCOUNT:
        return LedgerKey.account(_LKAccount(accountID=d.value.accountID))
    if t == LedgerEntryType.TRUSTLINE:
        return LedgerKey.trustLine(_LKTrustLine(
            accountID=d.value.accountID, asset=d.value.asset))
    if t == LedgerEntryType.OFFER:
        return LedgerKey.offer(_LKOffer(
            sellerID=d.value.sellerID, offerID=d.value.offerID))
    if t == LedgerEntryType.DATA:
        return LedgerKey.data(_LKData(
            accountID=d.value.accountID, dataName=d.value.dataName))
    if t == LedgerEntryType.CLAIMABLE_BALANCE:
        return LedgerKey.claimableBalance(_LKClaimableBalance(
            balanceID=d.value.balanceID))
    if t == LedgerEntryType.LIQUIDITY_POOL:
        return LedgerKey.liquidityPool(_LKLiquidityPool(
            liquidityPoolID=d.value.liquidityPoolID))
    if t == LedgerEntryType.CONTRACT_DATA:
        return LedgerKey.contractData(_LKContractData(
            contract=d.value.contract, key=d.value.key,
            durability=d.value.durability))
    if t == LedgerEntryType.CONTRACT_CODE:
        return LedgerKey.contractCode(_LKContractCode(hash=d.value.hash))
    if t == LedgerEntryType.CONFIG_SETTING:
        return LedgerKey.configSetting(_LKConfigSetting(
            configSettingID=d.value.configSettingID))
    if t == LedgerEntryType.TTL:
        return LedgerKey.ttl(_LKTtl(keyHash=d.value.keyHash))
    raise ValueError(f"no key for entry type {t}")


# Account LedgerKey XDR memo: the replay loop derives an account's key
# bytes on every load/update; the encoding is a pure function of the
# 32-byte public key, so memoize it (bounded — pubnet has ~10M accounts,
# a replay touches far fewer at once).
_ACCOUNT_KEY_XDR: dict = {}


def account_key_xdr(pk: bytes) -> bytes:
    kb = _ACCOUNT_KEY_XDR.get(pk)
    if kb is None:
        kb = LedgerKey.account(_LKAccount(
            accountID=AccountID.ed25519(pk))).to_xdr()
        if len(_ACCOUNT_KEY_XDR) < 1_000_000:
            _ACCOUNT_KEY_XDR[pk] = kb
    return kb


def ledger_entry_key_xdr(entry: "LedgerEntry") -> bytes:
    """ledger_entry_key(entry).to_xdr() with the account fast path."""
    d = entry.data
    if d.switch == LedgerEntryType.ACCOUNT:
        return account_key_xdr(d.value.accountID.value)
    return ledger_entry_key(entry).to_xdr()


# public aliases for the per-type LedgerKey structs (used by upper layers)
LedgerKeyAccount = _LKAccount
LedgerKeyTrustLine = _LKTrustLine
LedgerKeyOffer = _LKOffer
LedgerKeyData = _LKData
LedgerKeyClaimableBalance = _LKClaimableBalance
LedgerKeyLiquidityPool = _LKLiquidityPool
LedgerKeyContractData = _LKContractData
LedgerKeyContractCode = _LKContractCode
LedgerKeyConfigSetting = _LKConfigSetting
LedgerKeyTtl = _LKTtl
