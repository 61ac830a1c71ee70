"""lock-order: the static lock-acquisition graph must stay acyclic.

Extracts every ``with <lock>:`` acquisition (names ending in ``_lock`` —
`self._lock`, `snap._lock`, module-level `_LOCK`) across the tree,
identifies each lock by its owning class/module (lock *class*, not
instance: all Histogram._lock instances are one node, the standard
deadlock-analysis granularity), and builds the held-while-acquiring
graph:

  * lexically nested ``with`` blocks, and
  * calls made while holding a lock to same-class methods / same-module
    functions that themselves acquire a lock (one call-graph level).

A cycle in that graph is a potential ABBA deadlock and fails the lint.

Receiver resolution: `self._lock` belongs to the enclosing class;
`other._lock` resolves through local type evidence (`other: Snap`
annotations, `other = Snap(...)` constructor assignments, and
`self.attr = Snap(...)` for `self.attr._lock`).  An unresolvable
receiver becomes a distinct `?name` node — never collapsed into the
enclosing class (which would silently drop the edge as a self-edge) and
never merged with other unknowns (which would fabricate cycles).  Orders
statics can't resolve are the runtime tracer's job (util/lockorder.py,
STPU_LOCK_TRACE=1): it records the *real* acquisition DAG and
fail-stops on inversion.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..core import FileContext, Rule, Violation


def _is_lock_name(name: str) -> bool:
    # `lock` / `_lock` / `tree_lock` / `_LOCK`, but NOT `clock`/`block`
    low = name.lower()
    return low == "lock" or low.endswith("_lock")


def _lock_expr(node: ast.expr) -> Optional[Tuple[Optional[ast.expr], str]]:
    """(receiver, attr) for a lock-ish acquisition expr, else None.
    Receiver is None for a bare Name lock (module-level)."""
    if isinstance(node, ast.Attribute) and _is_lock_name(node.attr):
        return node.value, node.attr
    if isinstance(node, ast.Name) and _is_lock_name(node.id):
        return None, node.id
    return None


def _call_class_name(value: ast.expr, classes: Set[str]) -> Optional[str]:
    """`ClassName(...)` -> "ClassName" when ClassName is a module class."""
    if isinstance(value, ast.Call) and isinstance(value.func, ast.Name) \
            and value.func.id in classes:
        return value.func.id
    return None


class _ModuleScan(ast.NodeVisitor):
    """Per-module pass: with-lock nestings and per-function acquisitions."""

    def __init__(self, modname: str, classes: Set[str],
                 self_attr_types: Dict[Tuple[str, str], str]):
        self.mod = modname
        self.classes = classes
        # (class, attr) -> class of `self.attr = ClassName(...)`
        self.self_attr_types = self_attr_types
        self.cls_stack: List[str] = []
        self.fn_stack: List[Tuple[str, str]] = []  # (class, func)
        self.var_types_stack: List[Dict[str, str]] = []
        # (class, func) -> set of lock nodes it directly acquires
        self.fn_acquires: Dict[Tuple[str, str], Set[str]] = {}
        # edges observed lexically: (held, acquired, lineno)
        self.edges: List[Tuple[str, str, int]] = []
        # calls made while holding: (held_lock, class, callee, lineno)
        self.held_calls: List[Tuple[str, str, str, int]] = []
        self.held: List[str] = []

    # -- receiver resolution -------------------------------------------------
    def _infer_var_types(self, fn) -> Dict[str, str]:
        """name -> class for params annotated with a module class and
        locals assigned from a module-class constructor."""
        out: Dict[str, str] = {}
        args = fn.args
        for a in list(args.args) + list(args.kwonlyargs) \
                + ([args.vararg] if args.vararg else []) \
                + ([args.kwarg] if args.kwarg else []):
            if a.annotation is not None \
                    and isinstance(a.annotation, ast.Name) \
                    and a.annotation.id in self.classes:
                out[a.arg] = a.annotation.id
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                cls = _call_class_name(node.value, self.classes)
                if cls:
                    out[node.targets[0].id] = cls
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name) \
                    and isinstance(node.annotation, ast.Name) \
                    and node.annotation.id in self.classes:
                out[node.target.id] = node.annotation.id
        return out

    def _owner_for(self, recv: Optional[ast.expr]) -> str:
        here = self.cls_stack[-1] if self.cls_stack else "<module>"
        if recv is None:
            return "<module>"
        if isinstance(recv, ast.Name):
            if recv.id == "self":
                return here
            for scope in reversed(self.var_types_stack):
                if recv.id in scope:
                    return scope[recv.id]
            return self._unknown(recv.id)
        if isinstance(recv, ast.Attribute) \
                and isinstance(recv.value, ast.Name) \
                and recv.value.id == "self":
            t = self.self_attr_types.get((here, recv.attr))
            return t if t else self._unknown(f"self.{recv.attr}")
        # complex receiver: a distinct per-expression unknown node
        return self._unknown(ast.unparse(recv))

    def _unknown(self, label: str) -> str:
        """Unknown-receiver node scoped to the current function: the same
        name in one function plausibly means one object (intra-function
        cycles stay detectable), but across functions it must NOT merge —
        unrelated objects sharing a parameter name would otherwise
        fabricate cycles."""
        cls, fn = self.fn_stack[-1] if self.fn_stack \
            else ("<module>", "<module>")
        return f"?{cls}.{fn}.{label}"

    def _lock_node(self, recv: Optional[ast.expr], attr: str) -> str:
        return f"{self.mod}.{self._owner_for(recv)}.{attr}"

    # -- structure visitors --------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.cls_stack.append(node.name)
        self.generic_visit(node)
        self.cls_stack.pop()

    def _visit_fn(self, node) -> None:
        key = (self.cls_stack[-1] if self.cls_stack else "<module>",
               node.name)
        self.fn_stack.append(key)
        self.fn_acquires.setdefault(key, set())
        self.var_types_stack.append(self._infer_var_types(node))
        outer_held = self.held
        self.held = []  # held set does not cross function boundaries
        self.generic_visit(node)
        self.held = outer_held
        self.var_types_stack.pop()
        self.fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # a lambda body runs LATER, lock-free — calls inside it are not
        # "calls made while holding"
        outer_held = self.held
        self.held = []
        self.generic_visit(node)
        self.held = outer_held

    def visit_With(self, node: ast.With) -> None:
        n_acquired = 0
        for item in node.items:
            le = _lock_expr(item.context_expr)
            if le is None:
                self.visit(item.context_expr)
                continue
            ln = self._lock_node(*le)
            if self.fn_stack:
                self.fn_acquires[self.fn_stack[-1]].add(ln)
            for h in self.held:
                if h != ln:
                    self.edges.append((h, ln, node.lineno))
            # held immediately: `with a_lock, b_lock:` orders a before b
            self.held.append(ln)
            n_acquired += 1
        for st in node.body:
            self.visit(st)
        if n_acquired:
            del self.held[-n_acquired:]

    visit_AsyncWith = visit_With

    def visit_Call(self, node: ast.Call) -> None:
        if self.held:
            f = node.func
            callee = None
            cls = "<module>"
            if isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id == "self" and self.cls_stack:
                callee, cls = f.attr, self.cls_stack[-1]
            elif isinstance(f, ast.Name):
                callee = f.id
            if callee is not None:
                for h in self.held:
                    self.held_calls.append((h, cls, callee, node.lineno))
        self.generic_visit(node)


def _collect_self_attr_types(tree: ast.Module,
                             classes: Set[str]) -> Dict[Tuple[str, str], str]:
    """(class, attr) -> ClassName for every `self.attr = ClassName(...)`."""
    out: Dict[Tuple[str, str], str] = {}
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    c = _call_class_name(node.value, classes)
                    if c:
                        out[(cls.name, t.attr)] = c
    return out


class LockOrderRule(Rule):
    id = "lock-order"
    description = ("the static `with <lock>` acquisition graph (lexical "
                   "nesting + one call level) must be cycle-free")

    def finalize(self, ctxs: List[FileContext]) -> Iterator[Violation]:
        edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        scans: List[Tuple[FileContext, _ModuleScan]] = []
        for ctx in ctxs:
            mod = os.path.splitext(ctx.relpath)[0].replace("/", ".")
            classes = {n.name for n in ast.walk(ctx.tree)
                       if isinstance(n, ast.ClassDef)}
            scan = _ModuleScan(mod, classes,
                               _collect_self_attr_types(ctx.tree, classes))
            scan.visit(ctx.tree)
            scans.append((ctx, scan))
            for held, acq, lineno in scan.edges:
                edges.setdefault((held, acq), (ctx.relpath, lineno))
        # one call-graph level: held lock -> locks acquired by the callee
        for ctx, scan in scans:
            for held, cls, callee, lineno in scan.held_calls:
                # a `self.meth()` call resolves ONLY within its class —
                # falling back to a same-named module function would
                # fabricate edges that never happen at runtime
                acq = scan.fn_acquires.get((cls, callee), set())
                for ln in acq:
                    if ln != held:
                        edges.setdefault((held, ln), (ctx.relpath, lineno))
        yield from self._report_cycles(edges)

    def _report_cycles(self, edges) -> Iterator[Violation]:
        adj: Dict[str, List[str]] = {}
        for (a, b) in edges:
            adj.setdefault(a, []).append(b)
        color: Dict[str, int] = {}
        stack: List[str] = []
        seen_cycles: Set[frozenset] = set()

        def dfs(u: str):
            color[u] = 1
            stack.append(u)
            for v in adj.get(u, ()):
                if color.get(v, 0) == 0:
                    yield from dfs(v)
                elif color.get(v) == 1:
                    cyc = stack[stack.index(v):] + [v]
                    key = frozenset(cyc)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        path, lineno = edges[(u, v)]
                        yield Violation(
                            self.id, path, lineno, 0,
                            "lock-order cycle (potential ABBA deadlock): "
                            + " -> ".join(cyc))
            stack.pop()
            color[u] = 2

        for node in sorted(adj):
            if color.get(node, 0) == 0:
                yield from dfs(node)
