"""Deterministic fuzz harnesses for the tx-apply engine and the overlay.

Reference: src/test/fuzz.{h,cpp} + FuzzerImpl.{h,cpp} — stellar-core ships
two AFL-style persistent fuzz targets: `TransactionFuzzer` (XDR-mutated
operations applied against a small prepared ledger universe) and
`OverlayFuzzer` (mutated wire bytes fed to a peer connection).  This module
is the same idea with a seeded PRNG instead of AFL (no corpus/coverage
feedback in this environment): every crash is a genuine finding because the
engine's contract is that arbitrary input produces a result code or a
controlled drop — never an unhandled exception.

CLI: ``python -m stellar_core_tpu_torch fuzz --mode tx|overlay|xdr --iters N``.

The copy of stellar_core_tpu/fuzz.py: for a seed it draws the reference's
random sequence, so ``gen-fuzz`` writes the reference's corpus byte for
byte.
"""

from __future__ import annotations

import enum
import random
from typing import List, Optional, Tuple

from . import xdr as X
from .crypto.keys import SecretKey
from .util import logging as slog
from .xdr import codec as C

log = slog.get("Fuzz")


# ---------------------------------------------------------------------------
# generic structured-random XDR generation (the mutation engine)
# ---------------------------------------------------------------------------

_INTERESTING_INTS = (0, 1, -1, 2, 7, 100, 255, 256, 2**31 - 1, -2**31,
                     2**32 - 1, 2**63 - 1, -2**63, 10**7, 10**15)


def random_xdr_value(t, rng: random.Random, depth: int = 0):
    """Generate a random instance of any declared XDR type by introspecting
    the codec adapters — every struct field, union arm and array length is
    reachable.  Depth-bounded so recursive types (SCPQuorumSet) terminate."""
    t = C._as_type(t)
    if isinstance(t, C._EnumAdapter):
        return rng.choice(list(t.enum_cls))
    if isinstance(t, C.Opaque):
        return bytes(rng.getrandbits(8) for _ in range(t.n))
    if isinstance(t, (C.VarOpaque, C.XdrString)):
        if isinstance(t, C.XdrString):
            t = t._op
        n = rng.randrange(min(t.max_len, 64) + 1)
        return bytes(rng.getrandbits(8) for _ in range(n))
    if isinstance(t, C.FixedArray):
        return [random_xdr_value(t.elem, rng, depth + 1)
                for _ in range(t.n)]
    if isinstance(t, C.VarArray):
        cap = 0 if depth > 4 else min(t.max_len, 3)
        return [random_xdr_value(t.elem, rng, depth + 1)
                for _ in range(rng.randrange(cap + 1))]
    if isinstance(t, C.Optional):
        if depth > 4 or rng.random() < 0.5:
            return None
        return random_xdr_value(t.elem, rng, depth + 1)
    if isinstance(t, C._StructAdapter):
        return t.cls(**{fname: random_xdr_value(ftype, rng, depth + 1)
                        for fname, ftype in t.cls._spec})
    if isinstance(t, C._UnionAdapter):
        arms = list(t.cls._arms.items())
        sw, (name, arm_t) = rng.choice(arms)
        val = None if arm_t is None else random_xdr_value(arm_t, rng,
                                                          depth + 1)
        return t.cls(sw, val)
    if isinstance(t, C._Void):
        return None
    # forward-reference wrappers (recursive types like SCPQuorumSet)
    target = getattr(t, "_target", None)
    if target is not None:
        if depth > 5:
            # bottom out: a leaf instance with no recursion
            return random_xdr_value(target, rng, depth + 10)
        return random_xdr_value(target, rng, depth + 1)
    # integer primitives
    if isinstance(t, (C._Uint32,)):
        return rng.choice(_INTERESTING_INTS) % 2**32 \
            if rng.random() < 0.5 else rng.getrandbits(32)
    if isinstance(t, (C._Uint64,)):
        return rng.choice(_INTERESTING_INTS) % 2**64 \
            if rng.random() < 0.5 else rng.getrandbits(64)
    if isinstance(t, (C._Int32,)):
        v = rng.choice(_INTERESTING_INTS) if rng.random() < 0.5 \
            else rng.getrandbits(32) - 2**31
        return max(-2**31, min(2**31 - 1, v))
    if isinstance(t, (C._Int64,)):
        v = rng.choice(_INTERESTING_INTS) if rng.random() < 0.5 \
            else rng.getrandbits(64) - 2**63
        return max(-2**63, min(2**63 - 1, v))
    if isinstance(t, C._Bool):
        return bool(rng.getrandbits(1))
    raise TypeError(f"random_xdr_value: unhandled type {t!r}")


def mutate_bytes(data: bytes, rng: random.Random) -> bytes:
    """AFL-style byte mutations: flips, splices, truncation, extension."""
    buf = bytearray(data)
    for _ in range(rng.randrange(1, 8)):
        choice = rng.random()
        if not buf or choice < 0.5:
            if buf:
                buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
        elif choice < 0.7:
            pos = rng.randrange(len(buf) + 1)
            buf[pos:pos] = bytes(rng.getrandbits(8)
                                 for _ in range(rng.randrange(1, 5)))
        elif choice < 0.9:
            pos = rng.randrange(len(buf))
            del buf[pos:pos + rng.randrange(1, 5)]
        else:
            buf = buf[:rng.randrange(len(buf) + 1)]
    return bytes(buf)


# ---------------------------------------------------------------------------
# transaction fuzzer
# ---------------------------------------------------------------------------

class TransactionFuzzer:
    """Apply structured-random / byte-mutated transactions against a small
    prepared ledger (reference: FuzzerImpl::TransactionFuzzer — initialize
    a universe of accounts, then inject mutated Operation XDR).  Invariants
    are ON: a fuzz case that corrupts state trips them and is a finding."""

    NUM_ACCOUNTS = 8

    def __init__(self, seed: int = 0):
        from .ledger.manager import LedgerManager
        from .testutils import TestAccount, build_tx, create_account_op

        self.rng = random.Random(seed ^ 0xF022)
        self.network_id = b"\x42" * 32
        self.mgr = LedgerManager(self.network_id)
        self.mgr.start_new_ledger()
        root_secret = self.mgr.root_account_secret()
        root_entry = self.mgr.root.get_entry(
            X.LedgerKey.account(X.LedgerKeyAccount(
                accountID=X.AccountID.ed25519(
                    root_secret.public_key.ed25519))).to_xdr())
        root = TestAccount(self.mgr, root_secret,
                           root_entry.data.value.seqNum)
        self.accounts: List[TestAccount] = []
        ops, secrets = [], []
        for i in range(self.NUM_ACCOUNTS):
            sk = SecretKey(bytes([0xA0 + i]) * 32)
            secrets.append(sk)
            ops.append(create_account_op(
                X.AccountID.ed25519(sk.public_key.ed25519), 10_000_000_000))
        arts = self.mgr.close_ledger([root.tx(ops)], close_time=1000)
        seq_base = self.mgr.last_closed_ledger_seq << 32
        for sk in secrets:
            self.accounts.append(TestAccount(self.mgr, sk, seq_base))
        self._build_tx = build_tx
        self.crashes: List[Tuple[str, BaseException]] = []

    def _rand_account(self):
        return self.rng.choice(self.accounts)

    def _remap_into_universe(self, op: X.Operation) -> X.Operation:
        """Point random account fields at fuzz-universe accounts some of the
        time (reference: FuzzerImpl remaps generated IDs into its small
        address space so ops hit real state instead of all-NO_ACCOUNT)."""
        body = op.body.value
        if body is None or self.rng.random() < 0.3:
            return op
        known = self._rand_account().account_id
        for fname in ("destination", "trustor", "accountID"):
            if hasattr(body, fname) and self.rng.random() < 0.7:
                cur = getattr(body, fname)
                if isinstance(cur, X.MuxedAccount) or (
                        hasattr(cur, "switch")
                        and type(cur).__name__ == "MuxedAccount"):
                    setattr(body, fname, X.muxed_from_account_id(known))
                elif type(cur).__name__ in ("AccountID", "PublicKey"):
                    setattr(body, fname, known)
        return op

    def one_case(self, i: int) -> None:
        rng = self.rng
        kind = rng.random()
        try:
            if kind < 0.55:
                # structured-random ops in a well-signed tx from a real
                # account — reaches the op-apply layer
                n_ops = rng.randrange(1, 4)
                ops = []
                for _ in range(n_ops):
                    op = random_xdr_value(X.Operation, rng)
                    ops.append(self._remap_into_universe(op))
                acct = self._rand_account()
                frame = self._build_tx(self.network_id, acct.secret,
                                       acct.next_seq(), ops)
                self.mgr.close_ledger([frame], close_time=2000 + i)
            elif kind < 0.8:
                # byte-mutated valid envelope — exercises decode + apply
                acct = self._rand_account()
                from .testutils import native_payment_op
                frame = self._build_tx(
                    self.network_id, acct.secret, acct.seq_num + 1,
                    [native_payment_op(self._rand_account().account_id,
                                       rng.randrange(1, 1000))])
                blob = mutate_bytes(frame.envelope.to_xdr(), rng)
                try:
                    env = X.TransactionEnvelope.from_xdr(blob)
                except C.XdrError:
                    return  # rejected at decode — controlled
                except OverflowError:
                    return  # length prefix beyond buffer — controlled
                frame2 = self.mgr.make_frame(env)
                self.mgr.close_ledger([frame2], close_time=2000 + i)
            else:
                # fully random envelope (usually fails sig/seq checks)
                env = random_xdr_value(X.TransactionEnvelope, rng)
                frame = self.mgr.make_frame(env)
                self.mgr.close_ledger([frame], close_time=2000 + i)
        except Exception as e:  # noqa: BLE001 — the fuzz oracle
            self.crashes.append((f"case {i}", e))
            log.error("tx fuzz crash at case %d: %r", i, e)

    def run(self, iters: int = 500) -> List[Tuple[str, BaseException]]:
        for i in range(iters):
            self.one_case(i)
        return self.crashes


# ---------------------------------------------------------------------------
# overlay fuzzer
# ---------------------------------------------------------------------------

class OverlayFuzzer:
    """Feed mutated wire bytes / structured-random messages into an
    authenticated loopback pair (reference: FuzzerImpl::OverlayFuzzer).
    The receiving node must drop the peer or ignore the message — any
    escaping exception is a finding."""

    def __init__(self, seed: int = 0):
        from .herder.herder import Herder
        from .ledger.manager import LedgerManager
        from .overlay.overlay_manager import OverlayManager
        from .overlay.peer import make_loopback_pair
        from .simulation.simulation import qset_of
        from .util.clock import ClockMode, VirtualClock

        self.rng = random.Random(seed ^ 0x0E21A7)
        self.clock = VirtualClock(ClockMode.VIRTUAL_TIME)
        nid = b"\x77" * 32
        self.nodes = []
        sks = [SecretKey(bytes([0x61 + i]) * 32) for i in range(2)]
        qset = qset_of([sk.public_key.ed25519 for sk in sks], 2)
        for i, sk in enumerate(sks):
            lm = LedgerManager(nid)
            lm.start_new_ledger()
            herder = Herder(self.clock, lm, sk, qset)
            overlay = OverlayManager(self.clock, herder, nid, sk,
                                     auth_seed=bytes([0x51 + i]) * 32)
            self.nodes.append(overlay)
        self._pair = make_loopback_pair(*self.nodes)
        self._crank()
        assert self._pair[0].is_authenticated()
        self.crashes: List[Tuple[str, BaseException]] = []

    def _crank(self, n: int = 30) -> None:
        for _ in range(n):
            self.clock.crank()

    def _ensure_pair(self) -> None:
        from .overlay.peer import make_loopback_pair
        pa, pb = self._pair
        if not (pa.is_authenticated() and pb.is_authenticated()):
            self._pair = make_loopback_pair(*self.nodes)
            self._crank()

    def one_case(self, i: int) -> None:
        rng = self.rng
        self._ensure_pair()
        pa, pb = self._pair   # pa: node A's view (sender), pb: node B's
        try:
            choice = rng.random()
            if choice < 0.35:
                # raw garbage into the frame decoder
                blob = bytes(rng.getrandbits(8)
                             for _ in range(rng.randrange(1, 200)))
                pb.data_received(blob)
            elif choice < 0.6:
                # structured-random message through the real channel
                msg = random_xdr_value(X.StellarMessage, rng)
                try:
                    msg.to_xdr()
                except C.XdrError:
                    return
                pa.send_message(msg)
            else:
                # byte-mutated frame of a valid message
                msg = X.StellarMessage.getSCPLedgerSeq(rng.getrandbits(16))
                from .overlay.peer import frame_encode
                mac = X.HmacSha256Mac(mac=b"\x00" * 32)
                am = X.AuthenticatedMessage.v0(X.AuthenticatedMessageV0(
                    sequence=pb._recv_seq, message=msg, mac=mac))
                blob = mutate_bytes(frame_encode(am.to_xdr()), rng)
                pb.data_received(blob)
            self._crank(10)
        except Exception as e:  # noqa: BLE001
            self.crashes.append((f"case {i}", e))
            log.error("overlay fuzz crash at case %d: %r", i, e)

    def run(self, iters: int = 300) -> List[Tuple[str, BaseException]]:
        for i in range(iters):
            self.one_case(i)
        return self.crashes


# ---------------------------------------------------------------------------
# xdr round-trip fuzzer
# ---------------------------------------------------------------------------

def fuzz_xdr_roundtrip(seed: int = 0, iters: int = 2000) -> List[str]:
    """Every structured-random value must survive pack→unpack→pack
    byte-identically, and mutated bytes must either fail to parse or
    re-serialize canonically (the quiet risk SURVEY.md §7 flags: ledger
    hashes depend on byte-exact XDR)."""
    rng = random.Random(seed ^ 0xD8)
    roots = [X.TransactionEnvelope, X.LedgerEntry, X.StellarMessage,
             X.SCPEnvelope, X.LedgerHeader, X.BucketEntry]
    failures: List[str] = []
    for i in range(iters):
        cls = rng.choice(roots)
        val = random_xdr_value(cls, rng)
        try:
            blob = val.to_xdr()
        except C.XdrError:
            continue  # unrepresentable randoms (e.g. over-long) are fine
        back = cls.from_xdr(blob)
        if back.to_xdr() != blob:
            failures.append(f"case {i}: {cls.__name__} not canonical")
        mut = mutate_bytes(blob, rng)
        try:
            re_parsed = cls.from_xdr(mut)
        except (C.XdrError, OverflowError):
            continue  # rejected — controlled
        if re_parsed.to_xdr() != mut:
            # parsed-but-noncanonical mutants must NOT appear: unpack
            # enforces canonical form (padding, lengths); a mutant that
            # parses yet re-encodes differently would break content
            # addressing.  Trailing-byte truncation is the one allowed
            # case: from_xdr requires full consumption, so this is dead
            # unless a decoder bug exists.
            failures.append(f"case {i}: {cls.__name__} mutant "
                            "parsed non-canonically")
    return failures
