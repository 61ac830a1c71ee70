"""Determinism discipline: consensus-path rules.

stellar-core is a deterministic replicated state machine — every
validator must derive bit-identical ledger hashes from the same
externalized values.  The reference bans floats, wall-clock and
unordered iteration anywhere protocol-visible; these four rules make
that ban compile-time-checkable for this repo's consensus modules:

  iteration-order   iterating a set (or hash-keyed view) whose elements
                    flow into XDR encoding, hashing, escaping list
                    construction or broadcast order must go through
                    ``sorted(...)`` or an order-documented structure
  float-discipline  no float literals, ``float()`` or true division on
                    protocol-visible values (fees/thresholds/balances/
                    close times are integer math); metric/log/trace
                    sinks are exempt
  hash-order        no builtin ``hash()`` and no ``id()``-keyed ordering
                    (both are PYTHONHASHSEED/address-sensitive) outside
                    ``__hash__`` protocol methods
  rng-discipline    ``random`` module-level functions and ``os.urandom``
                    only through an injected seeded ``random.Random``

The scope below is THE single declaration of which modules count as
consensus-path (grep CONSENSUS_SCOPE); util/detguard.py is the runtime
complement and simulation/hashseed_diff.py the differential proof.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

from ..core import (FileContext, Rule, Violation, dotted_name,
                    import_aliases)

# Single source of truth for "consensus-path" modules.  A file is in
# scope when its repo-relative path contains one of these directory
# prefixes (segment-aware, robust to a --root above the repo root).
CONSENSUS_SCOPE = (
    "stellar_core_tpu_torch/scp/",
    "stellar_core_tpu_torch/herder/",
    "stellar_core_tpu_torch/ledger/",
    "stellar_core_tpu_torch/soroban/",
    "stellar_core_tpu_torch/transactions/",
    "stellar_core_tpu_torch/bucket/",
    "stellar_core_tpu_torch/xdr/",
)

# rng-discipline additionally covers the deterministic simulation layer:
# chaos/loadgen seed-threading is a repo invariant, not a
# consensus-only one.
RNG_EXTRA_SCOPE = (
    "stellar_core_tpu_torch/simulation/",
)


def in_consensus_scope(relpath: str,
                       extra: tuple = ()) -> bool:
    for prefix in CONSENSUS_SCOPE + extra:
        if relpath.startswith(prefix) or ("/" + prefix) in relpath:
            return True
    return False


def _parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def _ancestors(node: ast.AST,
               parents: Dict[ast.AST, ast.AST]) -> Iterator[ast.AST]:
    cur = parents.get(node)
    while cur is not None:
        yield cur
        cur = parents.get(cur)


# ---------------------------------------------------------------------------
# iteration-order
# ---------------------------------------------------------------------------

# Consuming a whole unordered iterable through one of these builtins is
# order-free (commutative / re-ordering): quiet.
_ORDER_FREE_CONSUMERS = {"sorted", "set", "frozenset", "sum", "min", "max",
                         "any", "all", "len", "dict"}

# A call to a method with one of these names inside the loop body marks
# the iteration order as escaping (list construction, XDR encoding,
# hashing, broadcast).
_ORDER_SINK_ATTRS = {"append", "extend", "insert", "to_xdr", "encode",
                     "pack", "sha256", "digest", "hexdigest", "broadcast",
                     "send_message", "emit_envelope", "flood", "write"}
_ORDER_SINK_NAMES = {"to_xdr", "sha256", "encode_xdr"}


class IterationOrderRule(Rule):
    id = "iteration-order"
    description = ("iterating a set/.keys()/.values()/.items() into an "
                   "order-sensitive sink (escaping list, XDR/hash, "
                   "broadcast) without sorted() in consensus scope")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if not in_consensus_scope(ctx.relpath):
            return
        parents = _parent_map(ctx.tree)
        scopes = [ctx.tree] + [
            n for n in ast.walk(ctx.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in scopes:
            yield from self._check_scope(ctx, scope, parents)

    # -- per-scope analysis -------------------------------------------------

    def _own_nodes(self, scope: ast.AST) -> Iterator[ast.AST]:
        """Walk `scope` without descending into nested function defs
        (those are separate scopes with their own locals)."""
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            n = stack.pop()
            yield n
            if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                stack.extend(ast.iter_child_nodes(n))

    def _check_scope(self, ctx: FileContext, scope: ast.AST,
                     parents: Dict[ast.AST, ast.AST]) -> Iterator[Violation]:
        unordered = self._unordered_locals(scope)
        sorted_sinks = self._sorted_consumed_names(scope)
        for node in self._own_nodes(scope):
            if isinstance(node, ast.For):
                why = self._unordered_reason(node.iter, unordered)
                if why is None:
                    continue
                sink = self._body_sink(node, sorted_sinks)
                if sink is None:
                    continue
                yield Violation(
                    self.id, ctx.relpath, node.lineno, node.col_offset,
                    f"iterating {why} into {sink} — nondeterministic "
                    f"order is protocol-visible; wrap in sorted() or "
                    f"document the ordering and suppress")
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp)):
                for gen in node.generators:
                    why = self._unordered_reason(gen.iter, unordered)
                    if why is None:
                        continue
                    if self._consumed_order_free(node, parents):
                        continue
                    kind = ("list comprehension"
                            if isinstance(node, ast.ListComp)
                            else "generator expression")
                    yield Violation(
                        self.id, ctx.relpath, node.lineno, node.col_offset,
                        f"{kind} over {why} preserves nondeterministic "
                        f"order — wrap the iterable in sorted() or feed "
                        f"an order-free consumer")
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Name) \
                    and node.func.id in ("list", "tuple") and node.args:
                why = self._unordered_reason(node.args[0], unordered)
                if why is None:
                    continue
                if self._consumed_order_free(node, parents):
                    continue
                yield Violation(
                    self.id, ctx.relpath, node.lineno, node.col_offset,
                    f"{node.func.id}() over {why} freezes nondeterministic "
                    f"order — use sorted() instead")

    def _unordered_locals(self, scope: ast.AST) -> Set[str]:
        """Names bound in this scope whose every assignment is an
        unordered (hash-ordered) expression."""
        unordered: Set[str] = set()
        poisoned: Set[str] = set()
        for _ in range(2):  # one propagation round for name = other_name
            for node in self._own_nodes(scope):
                if not isinstance(node, ast.Assign):
                    continue
                for tgt in node.targets:
                    if not isinstance(tgt, ast.Name):
                        continue
                    if self._unordered_reason(node.value, unordered):
                        if tgt.id not in poisoned:
                            unordered.add(tgt.id)
                    else:
                        poisoned.add(tgt.id)
                        unordered.discard(tgt.id)
        return unordered

    def _unordered_reason(self, expr: ast.AST,
                          unordered: Set[str]) -> Optional[str]:
        """Why `expr` iterates in hash order, or None if it does not."""
        if isinstance(expr, (ast.Set, ast.SetComp)):
            return "a set literal"
        if isinstance(expr, ast.Name) and expr.id in unordered:
            return f"set-valued local '{expr.id}'"
        if isinstance(expr, ast.BinOp) and isinstance(
                expr.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
            return (self._unordered_reason(expr.left, unordered)
                    or self._unordered_reason(expr.right, unordered))
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Name) and f.id in ("set", "frozenset"):
                return f"{f.id}()"
            if isinstance(f, ast.Attribute) \
                    and f.attr in ("keys", "values", "items", "difference",
                                   "union", "intersection",
                                   "symmetric_difference"):
                # .keys()/.values()/.items() on dicts are insertion-
                # ordered, but in consensus scope that order must be
                # *documented* load-bearing — flag and let the site
                # sort or suppress with the justification.
                return f".{f.attr}() view"
        if isinstance(expr, ast.DictComp):
            for gen in expr.generators:
                why = self._unordered_reason(gen.iter, unordered)
                if why:
                    return f"a dict built over {why}"
        return None

    def _sorted_consumed_names(self, scope: ast.AST) -> Set[str]:
        """Names X for which sorted(X)/X.sort() appears in this scope:
        appends to them are order-free accumulation."""
        out: Set[str] = set()
        for node in self._own_nodes(scope):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name) and f.id == "sorted" and node.args \
                    and isinstance(node.args[0], ast.Name):
                out.add(node.args[0].id)
            elif isinstance(f, ast.Attribute) and f.attr == "sort" \
                    and isinstance(f.value, ast.Name):
                out.add(f.value.id)
        return out

    def _body_sink(self, loop: ast.For,
                   sorted_sinks: Set[str]) -> Optional[str]:
        for node in ast.walk(loop):
            if isinstance(node, (ast.Yield, ast.YieldFrom)):
                return "a yield (caller-visible order)"
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _ORDER_SINK_ATTRS:
                if f.attr in ("append", "extend", "insert") \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id in sorted_sinks:
                    continue  # accumulator is sorted afterwards
                return f".{f.attr}()"
            if isinstance(f, ast.Name) and f.id in _ORDER_SINK_NAMES:
                return f"{f.id}()"
        return None

    def _consumed_order_free(self, node: ast.AST,
                             parents: Dict[ast.AST, ast.AST]) -> bool:
        """True when `node` is a direct argument of an order-free
        consumer like sorted()/set()/sum()."""
        parent = parents.get(node)
        return isinstance(parent, ast.Call) \
            and isinstance(parent.func, ast.Name) \
            and parent.func.id in _ORDER_FREE_CONSUMERS \
            and node in parent.args


# ---------------------------------------------------------------------------
# float-discipline
# ---------------------------------------------------------------------------

# Instrument/observability sinks: a float flowing only into these is
# monitoring, not protocol state (same sink model as metric-registry).
_METRIC_SINK_ATTRS = {"inc", "mark", "update", "set_source", "observe",
                      "gauge", "weak_gauge", "timer", "histogram",
                      "debug", "info", "warning", "error", "exception",
                      "critical", "log", "record", "mark_phase", "span",
                      "snapshot", "add_row", "set_slow_threshold"}
_METRIC_SINK_NAMES = {"record", "mark_phase", "span", "clock_anchor"}


class FloatDisciplineRule(Rule):
    id = "float-discipline"
    description = ("float literals / float() / true division producing "
                   "protocol-visible values in consensus scope (metric/"
                   "log/trace sinks exempt)")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if not in_consensus_scope(ctx.relpath):
            return
        parents = _parent_map(ctx.tree)
        for node in ast.walk(ctx.tree):
            kind = self._float_kind(node)
            if kind is None:
                continue
            if self._observability_sink(node, parents):
                continue
            yield Violation(
                self.id, ctx.relpath, node.lineno, node.col_offset,
                f"{kind} in consensus scope — fees/thresholds/balances/"
                f"close times are integer math; use // or scaled ints "
                f"(metric/log sinks are exempt)")

    def _float_kind(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, float):
            return f"float literal {node.value!r}"
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "float":
            return "float() conversion"
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            return "true division (/)"
        return None

    def _observability_sink(self, node: ast.AST,
                            parents: Dict[ast.AST, ast.AST]) -> bool:
        for anc in _ancestors(node, parents):
            if isinstance(anc, ast.JoinedStr):
                return True  # string formatting, not protocol state
            if isinstance(anc, ast.Call):
                f = anc.func
                if isinstance(f, ast.Attribute) \
                        and f.attr in _METRIC_SINK_ATTRS:
                    return True
                if isinstance(f, ast.Name) \
                        and f.id in _METRIC_SINK_NAMES:
                    return True
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return False  # crossed the enclosing function: no sink
        return False


# ---------------------------------------------------------------------------
# hash-order
# ---------------------------------------------------------------------------

_ORDERING_CALLS = {"sorted", "min", "max"}


class HashOrderRule(Rule):
    id = "hash-order"
    description = ("builtin hash() or id()-keyed ordering in consensus "
                   "scope — both are PYTHONHASHSEED/address-sensitive")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if not in_consensus_scope(ctx.relpath):
            return
        parents = _parent_map(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Name):
                continue
            if node.func.id == "hash":
                if self._inside_hash_protocol(node, parents):
                    continue
                yield Violation(
                    self.id, ctx.relpath, node.lineno, node.col_offset,
                    "builtin hash() is PYTHONHASHSEED-sensitive for "
                    "str/bytes — use sha256 (crypto) or document the "
                    "process-local use and suppress")
            elif node.func.id == "id":
                if not self._is_ordering_use(node, parents):
                    continue
                yield Violation(
                    self.id, ctx.relpath, node.lineno, node.col_offset,
                    "id()-keyed ordering depends on allocation addresses "
                    "— order by content or a stable position index")

    def _inside_hash_protocol(self, node: ast.AST,
                              parents: Dict[ast.AST, ast.AST]) -> bool:
        """hash() inside a __hash__ definition is the protocol itself
        (process-local by construction)."""
        for anc in _ancestors(node, parents):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc.name == "__hash__"
        return False

    def _is_ordering_use(self, node: ast.AST,
                         parents: Dict[ast.AST, ast.AST]) -> bool:
        """id() feeding sorted()/min()/max()/.sort() — but an id() used
        as a dict/lookup key (Subscript slice) is identity bookkeeping,
        not ordering."""
        prev = node
        for anc in _ancestors(node, parents):
            if isinstance(anc, ast.Subscript) and anc.slice is prev:
                return False
            if isinstance(anc, ast.Call):
                f = anc.func
                if isinstance(f, ast.Name) and f.id in _ORDERING_CALLS:
                    return True
                if isinstance(f, ast.Attribute) and f.attr == "sort":
                    return True
            if isinstance(anc, ast.Dict):
                return False  # dict key/value: identity bookkeeping
            prev = anc
        return False


# ---------------------------------------------------------------------------
# rng-discipline
# ---------------------------------------------------------------------------

_FORBIDDEN_RNG = {
    "random." + f for f in (
        "random", "randint", "randrange", "choice", "choices", "shuffle",
        "sample", "uniform", "getrandbits", "seed", "gauss",
        "normalvariate", "expovariate", "betavariate", "triangular",
        "vonmisesvariate", "paretovariate", "weibullvariate", "randbytes",
    )
} | {
    "os.urandom",
    "uuid.uuid1",
    "uuid.uuid4",
    "secrets.token_bytes",
    "secrets.token_hex",
    "secrets.token_urlsafe",
    "secrets.randbits",
    "secrets.randbelow",
    "secrets.choice",
    "random.SystemRandom",
}


class RngDisciplineRule(Rule):
    id = "rng-discipline"
    description = ("module-level random.*/os.urandom in consensus or "
                   "simulation scope — randomness must flow through an "
                   "injected seeded random.Random")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if not in_consensus_scope(ctx.relpath, extra=RNG_EXTRA_SCOPE):
            return
        aliases = import_aliases(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dn = dotted_name(node.func)
            if dn is None:
                continue
            head, _, tail = dn.partition(".")
            canonical = aliases.get(head)
            if canonical is None:
                continue
            resolved = canonical + ("." + tail if tail else "")
            if resolved in _FORBIDDEN_RNG:
                yield Violation(
                    self.id, ctx.relpath, node.lineno, node.col_offset,
                    f"{resolved}() draws from process-global/OS entropy "
                    f"— thread a seeded random.Random instance instead")
            elif resolved == "random.Random" and not node.args:
                yield Violation(
                    self.id, ctx.relpath, node.lineno, node.col_offset,
                    "random.Random() with no seed is entropy-seeded — "
                    "pass an explicit seed")
