"""ledger-txn-paths: every constructed LedgerTxn reaches commit/rollback.

A `LedgerTxn` bound to a name (not used as a context manager) must be
closed — `x.commit()` or `x.rollback()` — on every explicit control-flow
path that leaves the enclosing function (fall-off-end, `return`,
`raise`).  The reference enforces this at runtime (LedgerTxn's
assert-on-close / sealing discipline); this rule makes the common bug —
an early `return` that forgets the rollback — a compile-time failure.

Modeled flow: if/elif/else, while/for (+ break/continue), with,
try/except/else/finally, return, raise.  Implicit exceptions (any call
can raise) are NOT modeled — demanding try/finally around every
statement would drown the tree; the nested-txn runtime assertions still
cover that class.

Recognized closers beyond direct `x.commit()` / `x.rollback()`:
  * `return x` / `self.attr = x` — ownership escapes the function;
  * `if x._open: x.rollback()`    — the guard implies closed-after;
  * calls to a nested function defined in the same scope whose body
    closes `x` (the `use_pool()`-closure pattern in offer_ops).
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from ..core import FileContext, Rule, Violation

# exit kinds propagated by the abstract interpreter
FALL, RETURN, RAISE, BREAK, CONTINUE = range(5)

Exit = Tuple[int, bool, int]  # (kind, closed, lineno)


def _dedup(exits: List[Exit]) -> List[Exit]:
    """Collapse to one exit per (kind, closed), keeping the earliest
    line: the analysis carries ONE bit of state, so sequential branches
    would otherwise multiply paths 2^n and hang the gate."""
    best: dict = {}
    for kind, cl, ln in exits:
        key = (kind, cl)
        if key not in best or ln < best[key]:
            best[key] = ln
    return [(k, c, ln) for (k, c), ln in best.items()]


def _is_ledger_txn_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    name = f.id if isinstance(f, ast.Name) else \
        f.attr if isinstance(f, ast.Attribute) else None
    return name == "LedgerTxn"


def _is_close_call(node: ast.AST, var: str, closers: Set[str]) -> bool:
    """`var.commit()` / `var.rollback()` / `closer_fn()`."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in ("commit", "rollback") \
            and isinstance(f.value, ast.Name) and f.value.id == var:
        return True
    return isinstance(f, ast.Name) and f.id in closers


def _expr_closes(node: Optional[ast.AST], var: str,
                 closers: Set[str]) -> bool:
    """True when evaluating this expression CERTAINLY closes var: a close
    call in a position that is unconditionally evaluated.  Conditional
    positions — `ok and x.commit()`, `x.commit() if ok else None`, chained
    comparison tails, lambda/comprehension bodies (deferred) — don't
    count."""
    if node is None:
        return False
    stack: List[ast.AST] = [node]
    while stack:
        n = stack.pop()
        if _is_close_call(n, var, closers):
            return True
        if isinstance(n, ast.BoolOp):
            stack.append(n.values[0])  # later operands may short-circuit
        elif isinstance(n, ast.IfExp):
            stack.append(n.test)  # only the test always evaluates
        elif isinstance(n, ast.Compare):
            stack.append(n.left)
            if n.comparators:
                stack.append(n.comparators[0])  # later ones short-circuit
        elif isinstance(n, (ast.Lambda, ast.ListComp, ast.SetComp,
                            ast.DictComp, ast.GeneratorExp)):
            pass  # deferred / possibly-zero-iteration bodies
        else:
            stack.extend(ast.iter_child_nodes(n))
    return False


def _open_guard_target(test: ast.AST) -> Optional[str]:
    """`if x._open:` -> "x" (the closed-state guard special case)."""
    if isinstance(test, ast.Attribute) and test.attr == "_open" \
            and isinstance(test.value, ast.Name):
        return test.value.id
    return None


def _is_catch_all(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    return any(isinstance(n, ast.Name)
               and n.id in ("Exception", "BaseException") for n in names)


class _PathAnalyzer:
    """Abstract interpretation of a statement list with one bit of state:
    has the tracked txn been closed on this path."""

    def __init__(self, var: str, closers: Set[str]):
        self.var = var
        self.closers = closers

    def run(self, stmts: List[ast.stmt], closed: bool,
            entry_line: int = 0) -> List[Exit]:
        exits: List[Exit] = []
        cur: List[Exit] = [(FALL, closed, entry_line)]
        for st in stmts:
            nxt: List[Exit] = []
            for kind, cl, ln in cur:
                if kind != FALL:
                    exits.append((kind, cl, ln))
                else:
                    nxt.extend(self.stmt(st, cl))
            cur = _dedup(nxt)
            if not cur:
                break
        exits.extend(cur)
        return _dedup(exits)

    def stmt(self, st: ast.stmt, closed: bool) -> List[Exit]:
        ln = st.lineno
        if isinstance(st, ast.Return):
            if isinstance(st.value, ast.Name) and st.value.id == self.var:
                closed = True  # ownership transferred to the caller
            elif _expr_closes(st.value, self.var, self.closers):
                closed = True
            return [(RETURN, closed, ln)]
        if isinstance(st, ast.Raise):
            if _expr_closes(st.exc, self.var, self.closers):
                closed = True
            return [(RAISE, closed, ln)]
        if isinstance(st, ast.Break):
            return [(BREAK, closed, ln)]
        if isinstance(st, ast.Continue):
            return [(CONTINUE, closed, ln)]
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return [(FALL, closed, ln)]  # a definition, not execution
        if isinstance(st, (ast.Expr, ast.Assign, ast.AugAssign,
                           ast.AnnAssign)):
            if _expr_closes(getattr(st, "value", None), self.var,
                            self.closers):
                closed = True
            if isinstance(st, ast.Assign) \
                    and isinstance(st.value, ast.Name) \
                    and st.value.id == self.var \
                    and any(isinstance(t, ast.Attribute)
                            for t in st.targets):
                closed = True  # stored into longer-lived state: escapes
                # (a plain local alias is NOT an escape — it stays
                # untracked and conservatively unclosed)
            return [(FALL, closed, ln)]
        if isinstance(st, ast.If):
            if _open_guard_target(st.test) == self.var:
                # `if x._open:` — the then-branch runs with the txn open
                # (whatever the body does is analyzed normally); the
                # else/fall-through path implies it is already closed
                outs = self.run(st.body, False, ln)
                outs += self.run(st.orelse, True, ln) if st.orelse \
                    else [(FALL, True, ln)]
                return outs
            outs = self.run(st.body, closed, ln)
            outs += self.run(st.orelse, closed, ln) if st.orelse \
                else [(FALL, closed, ln)]
            return outs
        if isinstance(st, (ast.While, ast.For, ast.AsyncFor)):
            body_exits = self.run(st.body, closed, ln)
            # return/raise escape the loop with their own state; break
            # falls through to after-loop carrying its path's state
            outs = [(k, c, l) for k, c, l in body_exits
                    if k in (RETURN, RAISE)]
            outs += [(FALL, c, l) for k, c, l in body_exits if k == BREAK]
            # zero-iteration/condition-exhausted path runs orelse then
            # falls through with the entry state — except `while True`,
            # which only ever leaves via break/return/raise
            infinite = isinstance(st, ast.While) \
                and isinstance(st.test, ast.Constant) and bool(st.test.value)
            if not infinite:
                outs += self.run(st.orelse, closed, ln) if st.orelse \
                    else [(FALL, closed, ln)]
            return outs
        if isinstance(st, (ast.With, ast.AsyncWith)):
            entry = closed
            for item in st.items:
                ce = item.context_expr
                if isinstance(ce, ast.Name) and ce.id == self.var:
                    entry = True  # `with x:` — the CM protocol closes it
                elif _expr_closes(ce, self.var, self.closers):
                    entry = True
            return self.run(st.body, entry, ln)
        if isinstance(st, ast.Try):
            return self.try_stmt(st, closed)
        return [(FALL, closed, ln)]

    def try_stmt(self, st: ast.Try, closed: bool) -> List[Exit]:
        # does the finally block unconditionally close the txn?
        fin_closes = False
        if st.finalbody:
            fexits = self.run(st.finalbody, False, st.lineno)
            falls = [c for k, c, _ in fexits if k == FALL]
            fin_closes = bool(falls) and all(falls)

        # a catch-all handler absorbs the body's explicit raises (the
        # handler paths below model what happens next); typed handlers
        # may not match, so the raise also stays a possible exit
        catch_all = any(_is_catch_all(h) for h in st.handlers)
        body_exits = self.run(st.body, closed, st.lineno)
        outs: List[Exit] = []
        for kind, cl, ln in body_exits:
            if kind == FALL and st.orelse:
                outs.extend(self.run(st.orelse, cl, ln))
            elif kind == RAISE and catch_all:
                pass  # caught: continues in a handler path
            else:
                outs.append((kind, cl, ln))
        # handlers enter with the pessimistic entry state: the exception
        # may have struck before any close in the body ran
        for h in st.handlers:
            outs.extend(self.run(h.body, closed, h.lineno))
        if fin_closes:
            outs = [(k, True, ln) for k, _, ln in outs]
        return outs


def _nested_closers(fn: ast.AST, var: str) -> Set[str]:
    """Names of nested functions whose body closes `var` (closure over
    the outer binding)."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not fn:
            params = {a.arg for a in node.args.args}
            if var in params:
                continue  # shadowed: operates on its own parameter
            if any(_is_close_call(sub, var, set())
                   for sub in ast.walk(node)):
                out.add(node.name)
    return out


def _direct_body_walk(fn: ast.AST) -> Iterator[Tuple[List[ast.stmt],
                                                     ast.stmt]]:
    """(containing_block, stmt) for every statement in `fn`, NOT
    descending into nested function/class definitions."""
    stack: List[List[ast.stmt]] = [fn.body]
    while stack:
        blk = stack.pop()
        for st in blk:
            yield blk, st
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            for fld in ("body", "orelse", "finalbody"):
                sub = getattr(st, fld, None)
                if isinstance(sub, list) and sub and \
                        isinstance(sub[0], ast.stmt):
                    stack.append(sub)
            for h in getattr(st, "handlers", []):
                stack.append(h.body)


class LedgerTxnPathsRule(Rule):
    id = "ledger-txn-paths"
    description = ("a LedgerTxn bound to a name must reach commit()/"
                   "rollback() on every control-flow path (or be used "
                   "as a context manager)")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        for fn in ast.walk(ctx.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_fn(ctx, fn)

    def _check_fn(self, ctx: FileContext, fn: ast.AST):
        for blk, st in _direct_body_walk(fn):
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name) \
                    and _is_ledger_txn_call(st.value):
                var = st.targets[0].id
            elif isinstance(st, ast.AnnAssign) \
                    and isinstance(st.target, ast.Name) \
                    and st.value is not None \
                    and _is_ledger_txn_call(st.value):
                var = st.target.id
            else:
                continue
            closers = _nested_closers(fn, var)
            analyzer = _PathAnalyzer(var, closers)
            idx = blk.index(st)
            exits = analyzer.run(blk[idx + 1:], False, st.lineno)
            # the binding may sit inside a nested block (e.g. an if arm or
            # a try body): FALL exits then continue into the enclosing
            # flow, and RAISE exits may be caught by enclosing handlers —
            # neither is visible to this block-local analysis.  Only flag
            # exits that certainly leave the function: RETURN always, plus
            # FALL/RAISE when the block IS the function body.
            top_level = blk is fn.body
            bad = [ln for k, c, ln in exits if not c
                   and (k == RETURN
                        or (top_level and k in (FALL, RAISE)))]
            if bad:
                yield Violation(
                    self.id, ctx.relpath, st.lineno, st.col_offset,
                    f"LedgerTxn '{var}' can leave the function without "
                    f"commit()/rollback() (path exiting near line "
                    f"{min(bad)}); close it on every path or use "
                    f"`with LedgerTxn(...)`")
