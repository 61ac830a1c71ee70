"""Stellar-types.x equivalents (reference: src/protocol-curr/xdr/Stellar-types.x)."""

from .codec import (Int32, Int64, Opaque, Optional, Uint32, Uint64, VarOpaque,
                    Void, XdrString, xdr_enum, xdr_struct, xdr_union)

# typedefs
Hash = Opaque(32)
Uint256 = Opaque(32)
TimePoint = Uint64
Duration = Uint64
SequenceNumber = Int64
DataValue = VarOpaque(64)
Signature = VarOpaque(64)
SignatureHint = Opaque(4)
Thresholds = Opaque(4)
String32 = XdrString(32)
String64 = XdrString(64)
PoolID = Opaque(32)
AssetCode4 = Opaque(4)
AssetCode12 = Opaque(12)

CryptoKeyType = xdr_enum("CryptoKeyType", {
    "KEY_TYPE_ED25519": 0,
    "KEY_TYPE_PRE_AUTH_TX": 1,
    "KEY_TYPE_HASH_X": 2,
    "KEY_TYPE_ED25519_SIGNED_PAYLOAD": 3,
    "KEY_TYPE_MUXED_ED25519": 0x100,
})

PublicKeyType = xdr_enum("PublicKeyType", {
    "PUBLIC_KEY_TYPE_ED25519": 0,
})

SignerKeyType = xdr_enum("SignerKeyType", {
    "SIGNER_KEY_TYPE_ED25519": 0,
    "SIGNER_KEY_TYPE_PRE_AUTH_TX": 1,
    "SIGNER_KEY_TYPE_HASH_X": 2,
    "SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD": 3,
})

PublicKey = xdr_union("PublicKey", PublicKeyType, {
    PublicKeyType.PUBLIC_KEY_TYPE_ED25519: ("ed25519", Uint256),
})

NodeID = PublicKey
AccountID = PublicKey

SignerKeyEd25519SignedPayload = xdr_struct("SignerKeyEd25519SignedPayload", [
    ("ed25519", Uint256),
    ("payload", VarOpaque(64)),
])

SignerKey = xdr_union("SignerKey", SignerKeyType, {
    SignerKeyType.SIGNER_KEY_TYPE_ED25519: ("ed25519", Uint256),
    SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX: ("pre_auth_tx", Uint256),
    SignerKeyType.SIGNER_KEY_TYPE_HASH_X: ("hash_x", Uint256),
    SignerKeyType.SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD:
        ("ed25519_signed_payload", SignerKeyEd25519SignedPayload),
})

Curve25519Secret = xdr_struct("Curve25519Secret", [("key", Opaque(32))])
Curve25519Public = xdr_struct("Curve25519Public", [("key", Opaque(32))])
HmacSha256Key = xdr_struct("HmacSha256Key", [("key", Opaque(32))])
HmacSha256Mac = xdr_struct("HmacSha256Mac", [("mac", Opaque(32))])

# ExtensionPoint: union switch (int v) { case 0: void; }
ExtensionPoint = xdr_union("ExtensionPoint", Int32, {0: ("v0", None)})

Price = xdr_struct("Price", [("n", Int32), ("d", Int32)])
Liabilities = xdr_struct("Liabilities", [("buying", Int64), ("selling", Int64)])


def account_id(ed25519: bytes) -> "AccountID":
    return AccountID.ed25519(ed25519)


def node_id(ed25519: bytes) -> "NodeID":
    return NodeID.ed25519(ed25519)
