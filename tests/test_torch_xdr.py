"""The port's XDR copy against the JAX package's, type by type.

For every XDR type that ``stellar_core_tpu.xdr`` exports (struct and union
classes, enums and typedef instances), seeded random values are made on
both sides by one generator that walks the type's structure with the same
``random.Random`` draws; both sides must pack them to the same bytes and
unpack those bytes to values equal to what was packed.  In this process
the native serializer (_cxdr, built by each package's own build step)
packs and unpacks; the port's pure-Python path must give the same bytes.
A subprocess repeats the whole check with STELLAR_TPU_NO_CXDR=1, which
both codecs read at import, so both run their pure-Python paths.
"""

import enum
import os
import subprocess
import sys
from pathlib import Path
import random

import pytest

from stellar_core_tpu import xdr as RX
from stellar_core_tpu.xdr import codec as RC
from stellar_core_tpu_torch import xdr as PX
from stellar_core_tpu_torch.xdr import codec as PC

ROOT = Path(__file__).resolve().parent.parent
SEEDS = 3
MAX_DEPTH = 6


def exported_types(X, C):
    """{name: XdrType} of every exported struct, union, enum and typedef."""
    out = {}
    for name in sorted(dir(X)):
        obj = getattr(X, name)
        if name.startswith("_"):
            continue
        if isinstance(obj, type) and (issubclass(obj, enum.IntEnum)
                                      or hasattr(obj, "_xdr_adapter")):
            out[name] = C._as_type(obj)
        elif isinstance(obj, C.XdrType) and not isinstance(obj, type):
            out[name] = obj
    return out


def random_value(C, t, rng, depth=0):
    """A random value of XdrType t.  The walk depends only on t's shape and
    rng, so the two packages' generators draw alike.  Past MAX_DEPTH,
    optionals are absent and variable arrays empty, so recursive types end."""
    deep = depth >= MAX_DEPTH
    if isinstance(t, C._Int32):
        return rng.randrange(-2 ** 31, 2 ** 31)
    if isinstance(t, C._Uint32):
        return rng.randrange(2 ** 32)
    if isinstance(t, C._Int64):
        return rng.randrange(-2 ** 63, 2 ** 63)
    if isinstance(t, C._Uint64):
        return rng.randrange(2 ** 64)
    if isinstance(t, C._Bool):
        return rng.random() < 0.5
    if isinstance(t, C._Void):
        return None
    if isinstance(t, C._EnumAdapter):
        return rng.choice(list(t.enum_cls))
    if isinstance(t, C.Opaque):
        return bytes(rng.randrange(256) for _ in range(t.n))
    if isinstance(t, C.VarOpaque):
        n = rng.randrange(min(t.max_len, 9) + 1)
        return bytes(rng.randrange(256) for _ in range(n))
    if isinstance(t, C.XdrString):
        n = rng.randrange(min(t._op.max_len, 9) + 1)
        return bytes(rng.randrange(32, 127) for _ in range(n))
    if isinstance(t, C.FixedArray):
        return [random_value(C, t.elem, rng, depth + 1) for _ in range(t.n)]
    if isinstance(t, C.VarArray):
        n = 0 if deep else rng.randrange(min(t.max_len, 2) + 1)
        return [random_value(C, t.elem, rng, depth + 1) for _ in range(n)]
    if isinstance(t, C.Optional):
        if deep or rng.random() < 0.3:
            return None
        return random_value(C, t.elem, rng, depth + 1)
    if isinstance(t, C._StructAdapter):
        return t.cls(**{f: random_value(C, ft, rng, depth + 1)
                        for f, ft in t.cls._spec})
    if isinstance(t, C._UnionAdapter):
        cls = t.cls
        arms = sorted(cls._arms, key=int)
        if deep:
            arms = [k for k in arms if cls._arms[k][1] is None] or arms
        sw = None
        if cls._default is not None and (not arms or rng.random() < 0.2):
            sw_t = cls._switch_type
            if isinstance(sw_t, C._EnumAdapter):
                rest = [m for m in sw_t.enum_cls if m not in cls._arms]
                sw = rng.choice(rest) if rest else None
            else:
                sw = rng.choice([v for v in range(-3, 8) if v not in cls._arms])
        if sw is None:
            sw = rng.choice(arms)
        arm = cls._arm_for(sw)
        value = None if arm[1] is None else random_value(C, arm[1], rng,
                                                         depth + 1)
        return cls(sw, value)
    target = getattr(t, "_target", None)
    if target is not None:                     # a recursive forward reference
        return random_value(C, target, rng, depth)
    raise TypeError(f"no generator for {t!r}")


def check_types(names=None):
    """Pack and unpack every exported type on both sides; returns the
    number of values checked and a list of failures (empty when equal)."""
    ref, port = exported_types(RX, RC), exported_types(PX, PC)
    failures = []
    if sorted(ref) != sorted(port):
        failures.append(("exported names differ",
                         sorted(set(ref) ^ set(port))))
    checked = 0
    for name in names or sorted(ref):
        for seed in range(SEEDS):
            rv = random_value(RC, ref[name], random.Random(f"{name}/{seed}"))
            pv = random_value(PC, port[name], random.Random(f"{name}/{seed}"))
            rb, pb = ref[name].pack(rv), port[name].pack(pv)
            if rb != pb:
                failures.append((name, seed, "pack", rb.hex(), pb.hex()))
                continue
            if port[name]._pack_py(pv) != pb:
                failures.append((name, seed, "pure-python pack"))
            if port[name].unpack(pb) != pv:
                failures.append((name, seed, "port unpack"))
            if ref[name].unpack(rb) != rv:
                failures.append((name, seed, "reference unpack"))
            got, off = port[name].unpack_from(pb, 0)
            if got != pv or off != len(pb):
                failures.append((name, seed, "pure-python unpack"))
            checked += 1
    return checked, failures


def test_every_exported_type_packs_alike_with_cxdr():
    assert PC._cxdr is not None and RC._cxdr is not None, \
        "both native serializers should load here"
    assert PC._cxdr.__name__ == "stellar_core_tpu_torch._cxdr"
    checked, failures = check_types()
    assert failures == []
    assert checked == SEEDS * len(exported_types(RX, RC)) > 900


def test_every_exported_type_packs_alike_without_cxdr():
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
            "import test_torch_xdr as t\n"
            "assert t.PC._cxdr is None and t.RC._cxdr is None\n"
            "checked, failures = t.check_types()\n"
            "print(checked, failures[:5])\n")
    env = dict(os.environ, STELLAR_TPU_NO_CXDR="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT))
    env.pop("PYTEST_CURRENT_TEST", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    checked, failures = out.stdout.split(" ", 1)
    assert failures.strip() == "[]"
    assert int(checked) == SEEDS * len(exported_types(RX, RC))


def test_codec_rejections_match():
    """The same values are refused on both sides."""
    def refused(X, C):
        out = []
        for make in (lambda: X.Price(n=2 ** 31, d=1),
                     lambda: X.LedgerKey.account(X.LedgerKeyAccount(
                         accountID=X.AccountID.ed25519(b"\x01" * 31))),
                     lambda: X.Memo(99999, None),
                     lambda: X.TransactionResultResult(999999, None)):
            with pytest.raises(C.XdrError) as e:
                make().to_xdr()
            out.append(type(e.value).__name__)
        with pytest.raises(C.XdrError):
            X.Price.from_xdr(b"\x00" * 7)
        with pytest.raises(C.XdrError):
            X.Hash.unpack(b"\x00" * 33)
        return out

    assert refused(PX, PC) == refused(RX, RC)


def test_helpers_and_constants_match():
    pk = bytes(range(32))
    acct_r, acct_p = RX.account_id(pk), PX.account_id(pk)
    assert acct_p.to_xdr() == acct_r.to_xdr()
    assert PX.muxed_from_account_id(acct_p).to_xdr() == \
        RX.muxed_from_account_id(acct_r).to_xdr()
    assert PX.muxed_to_account_id(PX.muxed_from_account_id(acct_p)) == acct_p
    key_r = RX.LedgerKey.account(RX.LedgerKeyAccount(accountID=acct_r))
    key_p = PX.LedgerKey.account(PX.LedgerKeyAccount(accountID=acct_p))
    assert PX.account_key_xdr(pk) == RX.account_key_xdr(pk) == key_r.to_xdr()
    assert key_p.to_xdr() == key_r.to_xdr()
    for name in ("MAX_OPS_PER_TX", "MAX_SIGNERS", "MAX_TX_PER_LEDGER",
                 "AUTH_FLAG_BATCH", "BATCH_WIRE_MAX_MESSAGES",
                 "LIQUIDITY_POOL_FEE_V18", "MASK_ACCOUNT_FLAGS_V17",
                 "SCSYMBOL_LIMIT", "TX_ADVERT_VECTOR_MAX_SIZE",
                 "TX_DEMAND_VECTOR_MAX_SIZE"):
        assert getattr(PX, name) == getattr(RX, name), name


def test_deep_copy_equals():
    rng = random.Random(3)
    t = exported_types(PX, PC)["TransactionEnvelope"]
    v = random_value(PC, t, rng)
    c = PX.deep_copy_value(v)
    assert c == v and c is not v and t.pack(c) == t.pack(v)
