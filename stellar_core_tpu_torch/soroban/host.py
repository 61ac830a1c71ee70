"""Bounded deterministic Soroban host.

No wasm toolchain exists in this environment (SURVEY §2.4), so contracts
are drawn from a sanctioned table of BUILT-IN host functions selected by
``InvokeContractArgs.functionName`` — contract-data get/put/has/del/bump,
emit-event, checked arithmetic, sha256, and two adversarial helpers
(``fail`` traps, ``burn`` drains the cpu budget).  Every built-in runs
under a real resource Budget: each operation charges deterministic
cpu-instruction and memory costs up front, and the first charge past the
per-tx limit raises BudgetExceeded → the structured
RESOURCE_LIMIT_EXCEEDED result (fee charged, state untouched).

Determinism contract: host results depend only on (args, storage state,
budget limits) — no clocks, no iteration over unordered containers, no
float arithmetic — so serial and footprint-parallel apply produce
byte-identical results (asserted end-to-end in tests/test_soroban.py).
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Optional, Tuple

from .. import xdr as X

__all__ = ["Budget", "BudgetExceeded", "FootprintViolation", "HostError",
           "HOST_FUNCTIONS", "invoke_host_function", "result_hash"]


class HostError(Exception):
    """Structured host failure; `code` is the InvokeHostFunctionResultCode
    the op result carries (the tx fail-stops, the node does not)."""

    code = X.InvokeHostFunctionResultCode.INVOKE_HOST_FUNCTION_TRAPPED

    def __init__(self, msg: str, code=None):
        super().__init__(msg)
        if code is not None:
            self.code = code


class BudgetExceeded(HostError):
    code = X.InvokeHostFunctionResultCode.\
        INVOKE_HOST_FUNCTION_RESOURCE_LIMIT_EXCEEDED


class FootprintViolation(HostError):
    """Out-of-footprint access: the tx declared a footprint and touched a
    key outside it.  Fail-stops the TX (trap), never the node."""

    code = X.InvokeHostFunctionResultCode.INVOKE_HOST_FUNCTION_TRAPPED


class EntryArchived(HostError):
    code = X.InvokeHostFunctionResultCode.\
        INVOKE_HOST_FUNCTION_ENTRY_ARCHIVED


# ---------------------------------------------------------------------------
# Budget: cpu-instruction + memory metering
# ---------------------------------------------------------------------------

# Deterministic cost model (instruction / byte charges per host op).
# Values are scaled from soroban-env-host's calibrated cost types; the
# absolute numbers matter less than their being fixed and documented.
COST = {
    "dispatch": (500, 0),             # per host-function call
    "storage_read": (5_000, 0),       # + per-byte below
    "storage_write": (7_500, 0),
    "storage_has": (2_500, 0),
    "storage_del": (3_000, 0),
    "read_byte": (4, 1),              # per entry byte materialized
    "write_byte": (6, 1),
    "event": (2_000, 0),              # + per-byte of topics/data
    "event_byte": (4, 1),
    "u64_arith": (80, 0),
    "sha256_base": (3_000, 32),
    "sha256_byte": (30, 0),
    "scval_byte": (2, 1),             # per byte of SCVal (de)serialization
}


class Budget:
    """Per-transaction cpu-instruction and memory budget.  charge() is
    check-then-commit: a charge that would cross either limit raises
    BudgetExceeded WITHOUT recording partial spend, so the failure
    path is deterministic regardless of charge order granularity."""

    __slots__ = ("cpu_limit", "mem_limit", "cpu_used", "mem_used")

    def __init__(self, cpu_limit: int, mem_limit: int):
        self.cpu_limit = int(cpu_limit)
        self.mem_limit = int(mem_limit)
        self.cpu_used = 0
        self.mem_used = 0

    def charge(self, kind: str, units: int = 1) -> None:
        cpu, mem = COST[kind]
        ncpu = self.cpu_used + cpu * units
        nmem = self.mem_used + mem * units
        if ncpu > self.cpu_limit:
            raise BudgetExceeded(
                f"cpu budget exceeded: {ncpu} > {self.cpu_limit} ({kind})")
        if nmem > self.mem_limit:
            raise BudgetExceeded(
                f"mem budget exceeded: {nmem} > {self.mem_limit} ({kind})")
        self.cpu_used = ncpu
        self.mem_used = nmem

    def charge_raw(self, instructions: int) -> None:
        n = self.cpu_used + int(instructions)
        if n > self.cpu_limit:
            raise BudgetExceeded(
                f"cpu budget exceeded: {n} > {self.cpu_limit} (raw)")
        self.cpu_used = n


# ---------------------------------------------------------------------------
# SCVal argument helpers (strict: malformed args trap deterministically)
# ---------------------------------------------------------------------------

_U64_MAX = (1 << 64) - 1


def _want(args, n: int):
    if len(args) != n:
        raise HostError(f"expected {n} args, got {len(args)}")


def _as_u64(v) -> int:
    if v.switch != X.SCValType.SCV_U64:
        raise HostError(f"expected u64, got {v.switch!r}")
    return int(v.value)


def _as_sym(v) -> str:
    if v.switch != X.SCValType.SCV_SYMBOL:
        raise HostError(f"expected symbol, got {v.switch!r}")
    s = v.value
    return s.decode("ascii") if isinstance(s, bytes) else str(s)


def _as_bytes(v) -> bytes:
    if v.switch != X.SCValType.SCV_BYTES:
        raise HostError(f"expected bytes, got {v.switch!r}")
    return bytes(v.value)


def _durability(v):
    name = _as_sym(v)
    if name == "temp":
        return X.ContractDataDurability.TEMPORARY
    if name == "persistent":
        return X.ContractDataDurability.PERSISTENT
    raise HostError(f"bad durability symbol {name!r}")


def _u64(n: int):
    return X.SCVal.u64(n)


def _void():
    return X.SCVal.void()


# ---------------------------------------------------------------------------
# The built-in host-function table
# ---------------------------------------------------------------------------

def _fn_put(host, args):
    _want(args, 3)
    host.storage.put(args[0], _durability(args[2]), args[1])
    return _void()


def _fn_get(host, args):
    _want(args, 2)
    got = host.storage.get(args[0], _durability(args[1]))
    return got if got is not None else _void()


def _fn_has(host, args):
    _want(args, 2)
    return X.SCVal.b(host.storage.has(args[0], _durability(args[1])))


def _fn_del(host, args):
    _want(args, 2)
    host.storage.delete(args[0], _durability(args[1]))
    return _void()


def _fn_bump(host, args):
    """Read-modify-write a u64 counter (created at 0 when absent).  The
    workhorse of the loadgen mix: shared-counter traffic forces write-set
    overlap, so the footprint scheduler's clustering is exercised by
    REAL contention, not synthetic partitions."""
    _want(args, 3)
    dur = _durability(args[2])
    host.budget.charge("u64_arith")
    cur = host.storage.get(args[0], dur)
    base = 0 if cur is None or cur.switch != X.SCValType.SCV_U64 \
        else int(cur.value)
    n = (base + _as_u64(args[1])) & _U64_MAX
    host.storage.put(args[0], dur, _u64(n))
    return _u64(n)


def _fn_emit(host, args):
    _want(args, 2)
    host.emit_event(args[0], args[1])
    return _void()


def _fn_add(host, args):
    _want(args, 2)
    host.budget.charge("u64_arith")
    n = _as_u64(args[0]) + _as_u64(args[1])
    if n > _U64_MAX:
        raise HostError("u64 add overflow")
    return _u64(n)


def _fn_mul(host, args):
    _want(args, 2)
    host.budget.charge("u64_arith")
    n = _as_u64(args[0]) * _as_u64(args[1])
    if n > _U64_MAX:
        raise HostError("u64 mul overflow")
    return _u64(n)


def _fn_sha256(host, args):
    _want(args, 1)
    data = _as_bytes(args[0])
    host.budget.charge("sha256_base")
    host.budget.charge("sha256_byte", len(data))
    return X.SCVal.bytes(hashlib.sha256(data).digest())


def _fn_fail(host, args):
    raise HostError("contract called fail()")


def _fn_burn(host, args):
    """Spend `n` raw cpu instructions — the budget-differential helper:
    a burn past the declared instruction count MUST surface as the
    structured RESOURCE_LIMIT_EXCEEDED failure with state untouched."""
    _want(args, 1)
    host.budget.charge_raw(_as_u64(args[0]))
    return _void()


HOST_FUNCTIONS: Dict[str, Callable] = {
    "put": _fn_put,
    "get": _fn_get,
    "has": _fn_has,
    "del": _fn_del,
    "bump": _fn_bump,
    "emit": _fn_emit,
    "add": _fn_add,
    "mul": _fn_mul,
    "sha256": _fn_sha256,
    "fail": _fn_fail,
    "burn": _fn_burn,
}


class Host:
    """One invocation context: storage view + budget + event log."""

    def __init__(self, storage, budget: Budget, contract):
        self.storage = storage
        self.budget = budget
        self.contract = contract
        self.events: List[Tuple] = []

    def emit_event(self, topic, data) -> None:
        blob = topic.to_xdr() + data.to_xdr()
        self.budget.charge("event")
        self.budget.charge("event_byte", len(blob))
        self.events.append((self.contract, topic, data))


def invoke_host_function(invoke_args, storage, budget: Budget):
    """Execute one InvokeContractArgs against the built-in table.

    Returns (return_scval, events, host).  Raises HostError subclasses
    for every failure mode; callers map `.code` onto the op result."""
    name = invoke_args.functionName
    if isinstance(name, bytes):
        name = name.decode("ascii", "replace")
    fn = HOST_FUNCTIONS.get(name)
    if fn is None:
        raise HostError(f"unknown host function {name!r}")
    budget.charge("dispatch")
    for a in invoke_args.args:
        budget.charge("scval_byte", len(a.to_xdr()))
    host = Host(storage, budget, invoke_args.contractAddress)
    ret = fn(host, list(invoke_args.args))
    return ret, host.events, host


def result_hash(ret, events) -> bytes:
    """The success-arm Hash: sha256 over the XDR of the return value and
    every emitted event, in order — a deterministic commitment that the
    serial-vs-parallel differential can compare."""
    h = hashlib.sha256()
    h.update(ret.to_xdr())
    for contract, topic, data in events:
        h.update(contract.to_xdr())
        h.update(topic.to_xdr())
        h.update(data.to_xdr())
    return h.digest()
