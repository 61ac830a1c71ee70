"""The input of the channel-account configurations: a history archive made
from the run's seed by the frozen reference, in which payment services
submit through channel accounts, and what the reference's own closes of it
give (each ledger's hash and each transaction's result).

A service (an anchor, an exchange's withdrawals, a disbursement platform)
keeps one base account and `channels_per_service` channel accounts.  Each
of its transactions has a channel as its source, which supplies the
sequence number and pays the fee; its one payment operation has the base
account as its source; the envelope is signed by the channel's key and by
the base account's key (Stellar's channel-account pattern).

Layout (the configuration file gives the numbers), as lib/archive.py's
but for the services: in ledger 2 the root account funds the funders, in
transactions of at most 100 operations, and carries the tx-set limit's
upgrade; in ledger 3 each funder creates `create_per_tx` accounts (the
ordinary accounts, then each service's base account and channels); empty
ledgers fill the first checkpoint.  Each of the next `payment_ledgers`
ledgers holds `txs_per_ledger` one-payment transactions: first every
channel of every service once, its base account paying an ordinary
account drawn uniformly; then one payment from each of
`txs_per_ledger - services * channels_per_service` ordinary senders,
distinct and drawn uniformly, each signed by its master key alone, to
another ordinary account.  Every `corrupt_every`th payment transaction,
in ledger order, has one signature corrupted: an ordinary transaction's
one signature; of the service transactions picked, the channel's and the
base account's in turn, so that both results a bad co-signature gives are
compared (txBAD_AUTH where the channel's fails, txFAILED where the base
account's operation is not authorised).  Empty ledgers fill the second
checkpoint.  The seed draws the keys, destinations, senders and amounts;
every seed gives the same number of ledgers, transactions and
signatures.

generate() repeats lib/archive.generate's closes around this module's
plan."""

from __future__ import annotations

import os
import shutil
import time

import numpy as np

from ..refcore import xdr as X
from ..refcore.crypto import rfc8032
from ..refcore.history.archive import FileHistoryArchive
from ..refcore.history.manager import HistoryManager
from ..refcore.ledger.manager import LedgerManager
from . import ledgers as L
from .archive import CHECKPOINT, replay_range


def _plan(cfg: dict, seed: int, nid: bytes) -> tuple:
    """The set-up ledgers' and the payment ledgers' transactions, a list a
    ledger of (frame, pairs), the fixed verdict of each (pk, sig, hash),
    and the hashes of the service transactions whose channel's and whose
    base account's signature was corrupted."""
    n, per_tx = cfg["accounts"], cfg["create_per_tx"]
    n_srv, n_ch = cfg["services"], cfg["channels_per_service"]
    tpl = cfg["txs_per_ledger"]
    n_svc_tx = n_srv * n_ch
    n_own = tpl - n_svc_tx
    if cfg["payment_ledgers"] > CHECKPOINT or not 0 <= n_own <= n:
        raise ValueError("the payment ledgers fit one checkpoint, every "
                         "channel sends once a ledger, and a ledger's "
                         "ordinary senders are distinct accounts")
    seeds = L.key_seeds("account", seed, n)
    bseeds = L.key_seeds("base", seed, n_srv)
    cseeds = L.key_seeds("channel", seed, n_svc_tx)
    own = seeds + bseeds + cseeds
    n_funders = -(-len(own) // per_tx)
    fseeds = L.key_seeds("funder", seed, n_funders)
    pks = L.signer.public_keys(own + fseeds + [nid])
    apk, bpk = pks[:n], pks[n:n + n_srv]
    cpk = pks[n + n_srv:len(own)]
    fpk, root_pk = pks[len(own):-1], pks[-1]

    # ledger 2: root funds the funders, at most MAX_OPS_PER_TX a
    # transaction (the root account's seed is the network id); ledger 3:
    # the funders create the accounts
    cap = X.MAX_OPS_PER_TX
    specs = [(root_pk, (1 << 32) + 1 + t, [
        L.create_op(pk, (per_tx + 1) * L.BALANCE)
        for pk in fpk[t * cap:(t + 1) * cap]],
        100 * len(fpk[t * cap:(t + 1) * cap]), [(nid, root_pk)])
        for t in range(-(-n_funders // cap))]
    n_root = len(specs)
    specs += [(fpk[j], (2 << 32) + 1, [
        L.create_op(pk, L.BALANCE) for pk in pks[j * per_tx:
                                                 min(len(own),
                                                     (j + 1) * per_tx)]],
        100 * per_tx, [(fseeds[j], fpk[j])]) for j in range(n_funders)]
    seq = [(3 << 32)] * n
    cseq = [(3 << 32)] * n_svc_tx
    rng = np.random.default_rng(seed)
    for _ in range(cfg["payment_ledgers"]):
        dests = rng.integers(0, n, size=n_svc_tx)
        amounts = rng.integers(1, 10 ** 6, size=n_svc_tx)
        for c, (d, a) in enumerate(zip(dests.tolist(), amounts.tolist())):
            s = c // n_ch
            cseq[c] += 1
            op = L.payment_op(apk[d], a)
            op.sourceAccount = X.MuxedAccount.ed25519(bpk[s])
            specs.append((cpk[c], cseq[c], [op], 100,
                          [(cseeds[c], cpk[c]), (bseeds[s], bpk[s])]))
        senders = rng.choice(n, size=n_own, replace=False)
        dests = rng.integers(0, n - 1, size=n_own)
        amounts = rng.integers(1, 10 ** 6, size=n_own)
        for i, d, a in zip(senders.tolist(), dests.tolist(),
                           amounts.tolist()):
            seq[i] += 1
            specs.append((apk[i], seq[i], [L.payment_op(
                apk[d + (d >= i)], a)], 100, [(seeds[i], apk[i])]))

    built = L.build(nid, specs)
    blocks = [built[:n_root], built[n_root:n_root + n_funders]]
    pay = built[n_root + n_funders:]
    blocks += [pay[k:k + tpl] for k in range(0, len(pay), tpl)]
    verdicts = {p: True for _, pairs in built for p in pairs}
    every = cfg["corrupt_every"]
    bad_signer = ([], [])   # service transactions: channel's, base's
    for k, (frame, pairs) in enumerate(pay):
        if (k + 1) % every:
            continue
        which = 0
        if len(pairs) == 2:
            which = sum(map(len, bad_signer)) % 2
            bad_signer[which].append(frame.content_hash())
        pk, _, h = pairs[which]
        del verdicts[pairs[which]]
        pairs[which] = (pk, L.corrupt(frame, which), h)
        verdicts[pairs[which]] = False
    return blocks[:2], blocks[2:], verdicts, bad_signer


def generate(cfg: dict, seed: int, out_dir: str) -> dict:
    """Write the archive for `seed` into out_dir/archive (emptied first)
    and return the reference: each ledger's hash and each transaction's
    result code as the reference's closes give them, every account's
    balance and sequence number after the range's last ledger
    (`accounts`, ledgers.account_state), with the seconds each stage
    took, and the hashes of the service transactions whose
    channel's (bad_channel_txs) and whose base account's (bad_base_txs)
    signature was corrupted."""
    t0 = time.perf_counter()
    archive_dir = os.path.join(out_dir, "archive")
    shutil.rmtree(archive_dir, ignore_errors=True)
    os.makedirs(archive_dir)
    passphrase = cfg["passphrase"]
    nid = L.network_id(passphrase)
    mgr = LedgerManager(nid)
    mgr.start_new_ledger()
    history = HistoryManager(mgr, passphrase,
                             [FileHistoryArchive(archive_dir)])
    setup, payments, verdicts, bad_signer = _plan(cfg, seed, nid)
    t_plan = time.perf_counter()
    ledgers, n_tx = {}, 0

    def close(block, upgrades=()):
        nonlocal n_tx
        frames = [f for f, _ in block]
        seq = mgr.lcl_header.ledgerSeq + 1
        close_time = L.CLOSE_TIME_0 + L.CLOSE_EVERY_S * seq
        value = None
        if upgrades:
            tx_set, tx_set_hash, _ = mgr.make_tx_set(frames)
            value = X.StellarValue(txSetHash=tx_set_hash,
                                   closeTime=close_time,
                                   upgrades=list(upgrades))
        arts = mgr.close_ledger(frames, close_time, stellar_value=value)
        history.ledger_closed(arts)
        ledgers[seq] = {"hash": mgr.lcl_hash, "results": L.result_codes(arts)}
        n_tx += len(frames)

    def fill_checkpoint():
        while (mgr.lcl_header.ledgerSeq + 1) % CHECKPOINT:
            close([])

    L.clear_verdicts()
    L.seed_verdicts((pk, sig, h, ok) for (pk, sig, h), ok in verdicts.items())
    close(setup[0], [X.LedgerUpgrade.newMaxTxSetSize(
        cfg["max_tx_set_size"]).to_xdr()])
    close(setup[1])
    fill_checkpoint()
    for block in payments:
        close(block)
    accounts = L.account_state(mgr.root)
    fill_checkpoint()
    L.clear_verdicts()
    t_close = time.perf_counter()
    # the fixed verdicts against the reference's verifier: every
    # corrupted one and 1 in 64 of the others
    bad = [k for k, ok in verdicts.items() if not ok]
    sample = bad + [k for k, ok in verdicts.items() if ok][::64]
    wrong = [k for k in sample
             if rfc8032.verify(k[1], k[2], k[0]) != verdicts[k]]
    if wrong:
        raise AssertionError(f"{len(wrong)} fixed verdicts are not the "
                             f"reference verifier's")
    first, last = replay_range(cfg)
    return {"archive": archive_dir, "passphrase": passphrase, "nid": nid,
            "ledgers": ledgers, "accounts": accounts,
            "replay": (first, last),
            "transactions": n_tx, "signatures": len(verdicts),
            "corrupted": len(bad), "bad_channel_txs": bad_signer[0],
            "bad_base_txs": bad_signer[1], "plan_s": t_plan - t0,
            "close_s": t_close - t_plan,
            "check_s": time.perf_counter() - t_close}
