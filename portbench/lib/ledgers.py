"""Transactions built, signed and closed by the frozen reference
(portbench.refcore), shared by the benchmark's input generators and by the
comparisons that decide `correct`."""

from __future__ import annotations

import numpy as np

from ..refcore import xdr as X
from ..refcore.crypto import keys as rkeys
from ..refcore.crypto.sha import sha256
from ..refcore.transactions.frame import TransactionFrame
from . import signer

# the close time of ledger n in the benchmark's archives (a ledger every
# 5 s, as stellar-core's EXP_LEDGER_TIMESPAN_SECONDS)
CLOSE_TIME_0, CLOSE_EVERY_S = 1_600_000_000, 5
# every account's starting balance, in stroops (100,000 lumens)
BALANCE = 10 ** 12


def network_id(passphrase: str) -> bytes:
    return sha256(passphrase.encode())


def key_seeds(tag: str, seed: int, n: int) -> list:
    """n 32-byte Ed25519 seeds drawn from the run's seed."""
    return [sha256(f"portbench {tag} {seed} {i}".encode()) for i in range(n)]


def account_id(pk: bytes):
    return X.AccountID.ed25519(pk)


def create_op(pk: bytes, balance: int):
    return X.Operation(body=X.OperationBody.createAccountOp(
        X.CreateAccountOp(destination=account_id(pk),
                          startingBalance=balance)))


def payment_op(pk: bytes, amount: int):
    return X.Operation(body=X.OperationBody.paymentOp(X.PaymentOp(
        destination=X.MuxedAccount.ed25519(pk), asset=X.Asset.native(),
        amount=amount)))


def build(nid: bytes, specs: list) -> list:
    """specs: (source pk, seq, ops, fee, signers) with signers a list of
    (seed, pk).  Returns one (frame, [(pk, sig, hash)]) a spec, every
    signature made in one batch (signer.sign_all)."""
    frames, jobs = [], []
    for src, seq, ops, fee, signers in specs:
        tx = X.Transaction(
            sourceAccount=X.MuxedAccount.ed25519(src), fee=fee, seqNum=seq,
            cond=X.Preconditions.none(), memo=X.Memo.none(),
            operations=list(ops))
        env = X.TransactionEnvelope.v1(
            X.TransactionV1Envelope(tx=tx, signatures=[]))
        frame = TransactionFrame(nid, env)
        h = frame.content_hash()
        frames.append(frame)
        jobs += [(s, pk, h) for s, pk in signers]
    sigs = iter(signer.sign_all(jobs))
    out = []
    for frame, (_, _, _, _, signers) in zip(frames, specs):
        h, pairs = frame.content_hash(), []
        for _, pk in signers:
            sig = next(sigs)
            frame.envelope.value.signatures.append(X.DecoratedSignature(
                hint=pk[28:32], signature=sig))
            pairs.append((pk, sig, h))
        out.append((frame, pairs))
    return out


def corrupt(frame, index: int) -> tuple:
    """Flip the lowest bit of the first byte of the frame's `index`th
    signature; returns its new (pk-less) signature bytes."""
    d = frame.envelope.value.signatures[index]
    d.signature = bytes([d.signature[0] ^ 1]) + d.signature[1:]
    return d.signature


def seed_verdicts(entries) -> None:
    """The reference's verify cache, seeded with verdicts fixed by
    construction ((pk, sig, hash, verdict) a signature), so that its
    closes verify nothing again."""
    rkeys.seed_verify_cache(entries)


def clear_verdicts() -> None:
    rkeys.clear_verify_cache()


def result_codes(arts) -> dict:
    """{transaction hash: result code name} of a closed ledger."""
    return {p.transactionHash: p.result.result.switch.name
            for p in arts.result_entry.txResultSet.results}


def account_state(root) -> tuple:
    """(keys, balances, sequence numbers) of every account in a ledger
    root, in key order: the state each transaction's verdict decides
    (a success moves both, txBAD_AUTH and txFAILED the fee and the
    sequence number alone)."""
    keys, bal, seq = [], [], []
    for kb in sorted(root.all_keys()):
        e = root.get_entry(kb)
        if e.data.switch == X.LedgerEntryType.ACCOUNT:
            keys.append(kb)
            bal.append(e.data.value.balance)
            seq.append(e.data.value.seqNum)
    return keys, np.array(bal, np.int64), np.array(seq, np.int64)


def read_accounts(root, keys) -> tuple:
    """(balances, sequence numbers) of the accounts `keys` in a ledger
    root, -1 for an account it lacks."""
    bal = np.full(len(keys), -1, np.int64)
    seq = np.full(len(keys), -1, np.int64)
    get = root.get_entry
    for i, kb in enumerate(keys):
        e = get(kb)
        if e is not None:
            bal[i] = e.data.value.balance
            seq[i] = e.data.value.seqNum
    return bal, seq


def account_key(pk: bytes) -> bytes:
    """The XDR key of an account's ledger entry."""
    return X.LedgerKey.account(X.LedgerKeyAccount(
        accountID=account_id(pk))).to_xdr()
