"""Stellar-contract.x equivalents: the Soroban value and host-function
type system.

Reference: src/protocol-curr/xdr/Stellar-contract.x (SCVal and friends) +
the InvokeHostFunctionOp half of Stellar-transaction.x.  The wasm HOST is
out of scope (SURVEY.md §2.4 — no Rust toolchain; ops apply as
opNOT_SUPPORTED), but the SCHEMA is first-class: network envelopes and
ledger entries carrying Soroban payloads decode, round-trip byte-exactly
and content-address correctly, which is what catchup/history fidelity
needs even with a stubbed host.

SCVal is recursive (vectors/maps of SCVal); like SCPQuorumSet the knots are
tied with forward-reference adapters resolved after declaration.
"""

from .codec import (Bool, Int32, Int64, Uint32, Uint64, VarArray,
                    VarOpaque, XdrString, XdrType, xdr_enum, xdr_struct,
                    xdr_union)
from .codec import Optional as XOptional
from .types import AccountID, Hash, Uint256

# -- error values -----------------------------------------------------------

SCErrorType = xdr_enum("SCErrorType", {
    "SCE_CONTRACT": 0,
    "SCE_WASM_VM": 1,
    "SCE_CONTEXT": 2,
    "SCE_STORAGE": 3,
    "SCE_OBJECT": 4,
    "SCE_CRYPTO": 5,
    "SCE_EVENTS": 6,
    "SCE_BUDGET": 7,
    "SCE_VALUE": 8,
    "SCE_AUTH": 9,
})

SCErrorCode = xdr_enum("SCErrorCode", {
    "SCEC_ARITH_DOMAIN": 0,
    "SCEC_INDEX_BOUNDS": 1,
    "SCEC_INVALID_INPUT": 2,
    "SCEC_MISSING_VALUE": 3,
    "SCEC_EXISTING_VALUE": 4,
    "SCEC_EXCEEDED_LIMIT": 5,
    "SCEC_INVALID_ACTION": 6,
    "SCEC_INTERNAL_ERROR": 7,
    "SCEC_UNEXPECTED_TYPE": 8,
    "SCEC_UNEXPECTED_SIZE": 9,
})

# Upstream Stellar-contract.x: only SCE_CONTRACT carries contractCode and
# only SCE_VALUE / SCE_AUTH carry an SCErrorCode; the remaining arms are
# void.  Distinct arm names per void arm — the union machinery installs one
# constructor per name, so sharing "void" would pin it to the first arm.
SCError = xdr_union("SCError", SCErrorType, {
    SCErrorType.SCE_CONTRACT: ("contractCode", Uint32),
    SCErrorType.SCE_WASM_VM: ("wasmVm", None),
    SCErrorType.SCE_CONTEXT: ("context", None),
    SCErrorType.SCE_STORAGE: ("storage", None),
    SCErrorType.SCE_OBJECT: ("object", None),
    SCErrorType.SCE_CRYPTO: ("crypto", None),
    SCErrorType.SCE_EVENTS: ("events", None),
    SCErrorType.SCE_BUDGET: ("budget", None),
    SCErrorType.SCE_VALUE: ("code", SCErrorCode),
    SCErrorType.SCE_AUTH: ("code", SCErrorCode),
})

# -- multi-word integers ----------------------------------------------------

UInt128Parts = xdr_struct("UInt128Parts", [
    ("hi", Uint64), ("lo", Uint64)])

Int128Parts = xdr_struct("Int128Parts", [
    ("hi", Int64), ("lo", Uint64)])

UInt256Parts = xdr_struct("UInt256Parts", [
    ("hi_hi", Uint64), ("hi_lo", Uint64),
    ("lo_hi", Uint64), ("lo_lo", Uint64)])

Int256Parts = xdr_struct("Int256Parts", [
    ("hi_hi", Int64), ("hi_lo", Uint64),
    ("lo_hi", Uint64), ("lo_lo", Uint64)])

# -- addresses --------------------------------------------------------------

SCAddressType = xdr_enum("SCAddressType", {
    "SC_ADDRESS_TYPE_ACCOUNT": 0,
    "SC_ADDRESS_TYPE_CONTRACT": 1,
})

SCAddress = xdr_union("SCAddress", SCAddressType, {
    SCAddressType.SC_ADDRESS_TYPE_ACCOUNT: ("accountId", AccountID),
    SCAddressType.SC_ADDRESS_TYPE_CONTRACT: ("contractId", Hash),
})

# -- leaf payloads ----------------------------------------------------------

SCSYMBOL_LIMIT = 32
SCBytes = VarOpaque()
SCString = XdrString()
SCSymbol = XdrString(SCSYMBOL_LIMIT)

SCNonceKey = xdr_struct("SCNonceKey", [("nonce", Int64)])

ContractExecutableType = xdr_enum("ContractExecutableType", {
    "CONTRACT_EXECUTABLE_WASM": 0,
    "CONTRACT_EXECUTABLE_STELLAR_ASSET": 1,
})

ContractExecutable = xdr_union(
    "ContractExecutable", ContractExecutableType, {
        ContractExecutableType.CONTRACT_EXECUTABLE_WASM:
            ("wasm_hash", Hash),
        ContractExecutableType.CONTRACT_EXECUTABLE_STELLAR_ASSET:
            ("void", None),
    })

# -- the recursive SCVal ----------------------------------------------------

SCValType = xdr_enum("SCValType", {
    "SCV_BOOL": 0,
    "SCV_VOID": 1,
    "SCV_ERROR": 2,
    "SCV_U32": 3,
    "SCV_I32": 4,
    "SCV_U64": 5,
    "SCV_I64": 6,
    "SCV_TIMEPOINT": 7,
    "SCV_DURATION": 8,
    "SCV_U128": 9,
    "SCV_I128": 10,
    "SCV_U256": 11,
    "SCV_I256": 12,
    "SCV_BYTES": 13,
    "SCV_STRING": 14,
    "SCV_SYMBOL": 15,
    "SCV_VEC": 16,
    "SCV_MAP": 17,
    "SCV_ADDRESS": 18,
    "SCV_CONTRACT_INSTANCE": 19,
    "SCV_LEDGER_KEY_CONTRACT_INSTANCE": 20,
    "SCV_LEDGER_KEY_NONCE": 21,
})


class _SCValFwd(XdrType):
    """Forward reference breaking the SCVal ↔ SCVec/SCMap cycle (same
    pattern as the SCPQuorumSet knot in scp.py)."""
    _target = None

    def pack_into(self, val, out):
        self._target.pack_into(val, out)

    def unpack_from(self, buf, off):
        return self._target.unpack_from(buf, off)


_scval_fwd = _SCValFwd()

SCVec = XOptional(VarArray(_scval_fwd))        # SCVal vector, nullable Vec*
SCMapEntry = xdr_struct("SCMapEntry", [
    ("key", _scval_fwd), ("val", _scval_fwd)])
SCMap = XOptional(VarArray(SCMapEntry))

SCContractInstance = xdr_struct("SCContractInstance", [
    ("executable", ContractExecutable),
    ("storage", SCMap),
], defaults={"storage": None})

SCVal = xdr_union("SCVal", SCValType, {
    SCValType.SCV_BOOL: ("b", Bool),
    SCValType.SCV_VOID: ("void", None),
    SCValType.SCV_ERROR: ("error", SCError),
    SCValType.SCV_U32: ("u32", Uint32),
    SCValType.SCV_I32: ("i32", Int32),
    SCValType.SCV_U64: ("u64", Uint64),
    SCValType.SCV_I64: ("i64", Int64),
    SCValType.SCV_TIMEPOINT: ("timepoint", Uint64),
    SCValType.SCV_DURATION: ("duration", Uint64),
    SCValType.SCV_U128: ("u128", UInt128Parts),
    SCValType.SCV_I128: ("i128", Int128Parts),
    SCValType.SCV_U256: ("u256", UInt256Parts),
    SCValType.SCV_I256: ("i256", Int256Parts),
    SCValType.SCV_BYTES: ("bytes", SCBytes),
    SCValType.SCV_STRING: ("str", SCString),
    SCValType.SCV_SYMBOL: ("sym", SCSymbol),
    SCValType.SCV_VEC: ("vec", SCVec),
    SCValType.SCV_MAP: ("map", SCMap),
    SCValType.SCV_ADDRESS: ("address", SCAddress),
    SCValType.SCV_CONTRACT_INSTANCE: ("instance", SCContractInstance),
    SCValType.SCV_LEDGER_KEY_CONTRACT_INSTANCE:
        ("ledger_key_contract_instance", None),
    SCValType.SCV_LEDGER_KEY_NONCE: ("nonce_key", SCNonceKey),
})

_SCValFwd._target = SCVal._xdr_adapter()

# -- host functions (Stellar-transaction.x Soroban half) --------------------

ContractIDPreimageType = xdr_enum("ContractIDPreimageType", {
    "CONTRACT_ID_PREIMAGE_FROM_ADDRESS": 0,
    "CONTRACT_ID_PREIMAGE_FROM_ASSET": 1,
})


class _AssetFwd(XdrType):
    """Asset lives in ledger_entries, which imports this module for
    SCVal/SCAddress — ledger_entries ties this knot after defining Asset."""
    _target = None

    def pack_into(self, val, out):
        self._target.pack_into(val, out)

    def unpack_from(self, buf, off):
        return self._target.unpack_from(buf, off)


_asset_fwd = _AssetFwd()

ContractIDPreimage = xdr_union("ContractIDPreimage", ContractIDPreimageType, {
    ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ADDRESS:
        ("fromAddress", xdr_struct("ContractIDPreimageFromAddress", [
            ("address", SCAddress),
            ("salt", Uint256)])),
    ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ASSET:
        ("fromAsset", _asset_fwd),
})

CreateContractArgs = xdr_struct("CreateContractArgs", [
    ("contractIDPreimage", ContractIDPreimage),
    ("executable", ContractExecutable),
])

CreateContractArgsV2 = xdr_struct("CreateContractArgsV2", [
    ("contractIDPreimage", ContractIDPreimage),
    ("executable", ContractExecutable),
    ("constructorArgs", VarArray(SCVal)),
], defaults={"constructorArgs": list})

InvokeContractArgs = xdr_struct("InvokeContractArgs", [
    ("contractAddress", SCAddress),
    ("functionName", SCSymbol),
    ("args", VarArray(SCVal)),
], defaults={"args": list})

HostFunctionType = xdr_enum("HostFunctionType", {
    "HOST_FUNCTION_TYPE_INVOKE_CONTRACT": 0,
    "HOST_FUNCTION_TYPE_CREATE_CONTRACT": 1,
    "HOST_FUNCTION_TYPE_UPLOAD_CONTRACT_WASM": 2,
    "HOST_FUNCTION_TYPE_CREATE_CONTRACT_V2": 3,
})

HostFunction = xdr_union("HostFunction", HostFunctionType, {
    HostFunctionType.HOST_FUNCTION_TYPE_INVOKE_CONTRACT:
        ("invokeContract", InvokeContractArgs),
    HostFunctionType.HOST_FUNCTION_TYPE_CREATE_CONTRACT:
        ("createContract", CreateContractArgs),
    HostFunctionType.HOST_FUNCTION_TYPE_UPLOAD_CONTRACT_WASM:
        ("wasm", VarOpaque()),
    HostFunctionType.HOST_FUNCTION_TYPE_CREATE_CONTRACT_V2:
        ("createContractV2", CreateContractArgsV2),
})

# -- authorization ----------------------------------------------------------

SorobanAuthorizedFunctionType = xdr_enum("SorobanAuthorizedFunctionType", {
    "SOROBAN_AUTHORIZED_FUNCTION_TYPE_CONTRACT_FN": 0,
    "SOROBAN_AUTHORIZED_FUNCTION_TYPE_CREATE_CONTRACT_HOST_FN": 1,
    "SOROBAN_AUTHORIZED_FUNCTION_TYPE_CREATE_CONTRACT_V2_HOST_FN": 2,
})

SorobanAuthorizedFunction = xdr_union(
    "SorobanAuthorizedFunction", SorobanAuthorizedFunctionType, {
        SorobanAuthorizedFunctionType
        .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CONTRACT_FN:
            ("contractFn", InvokeContractArgs),
        SorobanAuthorizedFunctionType
        .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CREATE_CONTRACT_HOST_FN:
            ("createContractHostFn", CreateContractArgs),
        SorobanAuthorizedFunctionType
        .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CREATE_CONTRACT_V2_HOST_FN:
            ("createContractV2HostFn", CreateContractArgsV2),
    })


class _AuthInvocationFwd(XdrType):
    _target = None

    def pack_into(self, val, out):
        self._target.pack_into(val, out)

    def unpack_from(self, buf, off):
        return self._target.unpack_from(buf, off)


_auth_inv_fwd = _AuthInvocationFwd()

SorobanAuthorizedInvocation = xdr_struct("SorobanAuthorizedInvocation", [
    ("function", SorobanAuthorizedFunction),
    ("subInvocations", VarArray(_auth_inv_fwd)),
], defaults={"subInvocations": list})

_AuthInvocationFwd._target = SorobanAuthorizedInvocation._xdr_adapter()

SorobanCredentialsType = xdr_enum("SorobanCredentialsType", {
    "SOROBAN_CREDENTIALS_SOURCE_ACCOUNT": 0,
    "SOROBAN_CREDENTIALS_ADDRESS": 1,
})

SorobanAddressCredentials = xdr_struct("SorobanAddressCredentials", [
    ("address", SCAddress),
    ("nonce", Int64),
    ("signatureExpirationLedger", Uint32),
    ("signature", SCVal),
])

SorobanCredentials = xdr_union(
    "SorobanCredentials", SorobanCredentialsType, {
        SorobanCredentialsType.SOROBAN_CREDENTIALS_SOURCE_ACCOUNT:
            ("void", None),
        SorobanCredentialsType.SOROBAN_CREDENTIALS_ADDRESS:
            ("address", SorobanAddressCredentials),
    })

SorobanAuthorizationEntry = xdr_struct("SorobanAuthorizationEntry", [
    ("credentials", SorobanCredentials),
    ("rootInvocation", SorobanAuthorizedInvocation),
])
