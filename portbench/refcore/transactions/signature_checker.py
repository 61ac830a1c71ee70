"""SignatureChecker — THE offload seam to the card (BASELINE.json north star #1).

Reference: src/transactions/SignatureChecker.{h,cpp} — given a tx's signature
payload hash and decorated signatures, answer per-source-account threshold
checks (checkSignature) with hint matching and used-signature tracking, then
checkAllSignaturesUsed.

Ed25519 verdicts flow through crypto.keys.verify_sig, which consults the
process verify cache first; the card's batch path (accel) pre-verifies a whole
work unit and seeds that cache, so this class is oblivious to where the
verdict was computed — exactly the seam the reference comment promises
("call sites stay byte-identical").
"""

from __future__ import annotations

from typing import List, Sequence

from .. import xdr as X
from ..crypto import keys
from ..crypto.sha import sha256


class SignatureChecker:
    def __init__(self, protocol_version: int, content_hash: bytes,
                 signatures: Sequence[X.DecoratedSignature]):
        self.protocol_version = protocol_version
        self.content_hash = content_hash
        self.signatures = list(signatures)
        self.used = [False] * len(self.signatures)

    def check_signature(self, signers: List[X.Signer],
                        needed_weight: int) -> bool:
        """Accumulate weight from signatures matching `signers` until
        needed_weight is met.  Marks used signatures.  Signer kinds:
        ed25519 (verify against content hash), preAuthTx (sig ignored; the
        signer key IS the tx hash), hashX (sha256(sig) == key)."""
        total = 0
        # preAuthTx signers contribute without consuming a signature
        for signer in signers:
            if signer.key.switch == X.SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX:
                if signer.key.value == self.content_hash:
                    total += signer.weight
                    if total > 0 and total >= needed_weight:
                        return True
        # NOTE: a used signature is NOT consumed — one signature may satisfy
        # the tx-level check and several ops.  `used` only records that it
        # was useful at least once (checkAllSignaturesUsed's question).
        for i, dsig in enumerate(self.signatures):
            for signer in signers:
                kt = signer.key.switch
                if kt == X.SignerKeyType.SIGNER_KEY_TYPE_ED25519:
                    pk_bytes = signer.key.value
                    if dsig.hint != pk_bytes[28:32]:
                        continue
                    if not keys.verify_sig(keys.PublicKey(pk_bytes),
                                           dsig.signature, self.content_hash):
                        continue
                elif kt == X.SignerKeyType.SIGNER_KEY_TYPE_HASH_X:
                    if dsig.hint != signer.key.value[28:32]:
                        continue
                    if sha256(dsig.signature) != signer.key.value:
                        continue
                else:
                    continue
                self.used[i] = True
                total += signer.weight
                break
            if total > 0 and total >= needed_weight:
                return True
        # Zero accumulated weight never authorizes — a threshold of 0 (the
        # default account thresholds are [1,0,0,0]) still demands at least
        # one valid signature; otherwise unsigned txs would pass and
        # master-weight-0 "locked" accounts would unlock.
        return False

    def check_all_signatures_used(self) -> bool:
        return all(self.used)
