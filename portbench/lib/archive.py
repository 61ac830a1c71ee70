"""The catchup configurations' input: a history archive made from the run's
seed by the frozen reference, and what the reference's own closes of it
give (each ledger's hash, each transaction's result, and every account's
balance and sequence number after the replayed range), against which the
replay is compared.

Layout (a configuration file gives the numbers): ledger 2 carries the
tx-set limit's upgrade to `max_tx_set_size` and the root account's one
transaction that funds the funders; in ledger 3 each funder creates
`create_per_tx` accounts with one transaction; empty ledgers fill the
first checkpoint.  The next `payment_ledgers` ledgers each hold
`txs_per_ledger` one-payment transactions, each from a distinct source
account drawn uniformly (without replacement within a ledger) and signed
by its master key alone; destinations are drawn uniformly from the other
accounts.  Every `corrupt_every`th payment signature is corrupted, so its
transaction fails.  Empty ledgers fill the second checkpoint.  A replay
applies the first checkpoint's buckets and replays the payment ledgers:
every ledger it closes is a full payment ledger.  The seed draws the
keys, the senders, destinations and amounts; every seed gives the same
number of ledgers, transactions and signatures."""

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

CHECKPOINT = 64


def replay_range(cfg: dict) -> tuple:
    """(first, last) ledger a pass replays: the payment ledgers, after
    the first checkpoint's buckets."""
    return CHECKPOINT, CHECKPOINT - 1 + cfg["payment_ledgers"]


def _plan(cfg: dict, seed: int, nid: bytes) -> tuple:
    """The set-up ledgers' and the payment ledgers' transactions, a list a
    ledger of (frame, pairs), and the fixed verdict of each (pk, sig,
    hash)."""
    n, per_tx = cfg["accounts"], cfg["create_per_tx"]
    n_funders = -(-n // per_tx)
    tpl = cfg["txs_per_ledger"]
    if cfg["payment_ledgers"] > CHECKPOINT or tpl > n:
        raise ValueError("the payment ledgers fit one checkpoint, and a "
                         "ledger's senders are distinct accounts")
    seeds = L.key_seeds("account", seed, n)
    fseeds = L.key_seeds("funder", seed, n_funders)
    pks = L.signer.public_keys(seeds + fseeds + [nid])
    apk, fpk, root_pk = pks[:n], pks[n:n + n_funders], pks[-1]

    # ledger 2: root funds the funders (the root account's seed is the
    # network id); ledger 3: the funders create the accounts
    specs = [(root_pk, (1 << 32) + 1, [
        L.create_op(pk, (per_tx + 1) * L.BALANCE) for pk in fpk],
        100 * n_funders, [(nid, root_pk)])]
    specs += [(fpk[j], (2 << 32) + 1, [
        L.create_op(apk[i], L.BALANCE)
        for i in range(j * per_tx, min(n, (j + 1) * per_tx))],
        100 * per_tx, [(fseeds[j], fpk[j])]) for j in range(n_funders)]
    seq = [(3 << 32)] * n
    rng = np.random.default_rng(seed)
    for _ in range(cfg["payment_ledgers"]):
        senders = rng.choice(n, size=tpl, replace=False)
        dests = rng.integers(0, n - 1, size=tpl)
        amounts = rng.integers(1, 10 ** 6, size=tpl)
        for i, d, a in zip(senders.tolist(), dests.tolist(),
                           amounts.tolist()):
            seq[i] += 1
            specs.append((apk[i], seq[i], [L.payment_op(
                apk[d + (d >= i)], a)], 100, [(seeds[i], apk[i])]))

    built = L.build(nid, specs)
    blocks = [built[:1], built[1:1 + n_funders]]
    pay = built[1 + n_funders:]
    blocks += [pay[k:k + tpl] for k in range(0, len(pay), tpl)]
    verdicts = {p: True for _, pairs in built for p in pairs}
    every = cfg["corrupt_every"]
    for k, (frame, pairs) in enumerate(pay):
        if (k + 1) % every == 0:
            pk, _, h = pairs[0]
            del verdicts[pairs[0]]
            pairs[0] = (pk, L.corrupt(frame, 0), h)
            verdicts[pairs[0]] = False
    return blocks[:2], blocks[2:], verdicts


def generate(cfg: dict, seed: int, out_dir: str) -> dict:
    """Write the archive for `seed` into out_dir/archive (emptied first)
    and return the reference: each ledger's hash and each transaction's
    result code as the reference's closes give them, every account's
    balance and sequence number after the range's last ledger
    (`accounts`, ledgers.account_state), with the seconds each stage
    took."""
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
    setup, payments, verdicts = _plan(cfg, seed, nid)
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
            "corrupted": len(bad), "plan_s": t_plan - t0,
            "close_s": t_close - t_plan,
            "check_s": time.perf_counter() - t_close}
