"""thread-safety rule family: lock COVERAGE, not just lock order.

``thread-safety`` — discover every thread entry point in the tree
(``threading.Thread(target=...)`` spawns, including targets reached
through closures and ``functools.partial``; every method of a
``BaseHTTPRequestHandler`` subclass, which the stdlib server runs on
admin worker threads; worker bodies like PreverifyPipeline's device
thread) and build a call-graph reachability map from each entry point to
the instance fields it reads/writes.  Callbacks registered through
``clock.post_action``/``VirtualTimer.expires_from_now`` are re-rooted at
the MAIN role — posting is cross-thread, running is not.  A field
reachable from two or more thread roles, with at least one write outside
``__init__``, must have every post-init access inside a ``with
<lock>``-style guard, or carry an explicit ownership annotation::

    # corelint: owned-by=<thread-role> -- reason

on one of its access/declaration lines.  Fields written only in
``__init__`` are init-then-publish immutable and exempt (the runtime
sanitizer's Exclusive state is the dynamic twin of this rule — see
util/racetrace.py).  The static guard check is coverage-only (SOME lock
is held); whether it is the RIGHT lock is the runtime lockset's job.

``raw-lock`` — ``threading.Lock()`` / ``threading.RLock()`` may only be
constructed inside util/lockorder.py: every lock in the tree goes through
``make_lock``/``make_rlock`` so it is nameable, order-traced, and visible
to the race sanitizer's lockset.

Resolution honesty (same stance as the lock-order rule): receivers
resolve through explicit evidence only — ``self``, ``x = self``,
constructor assignments, ``Name`` annotations on params/locals, and
relative/absolute imports.  An unresolvable callee is dropped, never
guessed; the runtime layer covers what statics cannot see.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..core import FileContext, Rule, Violation, path_is

_OWNED_RE = re.compile(
    r"#\s*corelint:\s*owned-by\s*=\s*([A-Za-z0-9_.-]+)\s*(--\s*\S.*)?$")

MAIN_ROLE = "main"

# call-shapes that re-root their function argument onto the main role
# (the clock loop runs them), and the positional index of that argument
_MAIN_CALLBACK_REGS = {"post_action": 0, "expires_from_now": 1,
                       "crank_until": 0}
_HTTP_BASE = "BaseHTTPRequestHandler"


def _is_lock_name(name: str) -> bool:
    low = name.lower()
    return low == "lock" or low.endswith("_lock")


ClassKey = Tuple[str, str]        # (dotted module, ClassName)


class _ClassInfo:
    __slots__ = ("key", "bases", "attr_types", "decl_lines", "is_http")

    def __init__(self, key: ClassKey, bases: List[str], is_http: bool):
        self.key = key
        self.bases = bases                      # dotted/raw base names
        self.attr_types: Dict[str, str] = {}    # attr -> dotted class name
        self.decl_lines: Dict[str, List[int]] = {}  # attr -> class-body lines
        self.is_http = is_http


class _FuncUnit:
    __slots__ = ("uid", "module", "relpath", "cls", "name", "parent",
                 "children", "var_types", "accesses", "calls", "spawns",
                 "cb_targets")

    def __init__(self, uid: str, module: str, relpath: str,
                 cls: Optional[ClassKey], name: str,
                 parent: Optional["_FuncUnit"]):
        self.uid = uid
        self.module = module
        self.relpath = relpath
        self.cls = cls                 # owning class for `self` accesses
        self.name = name
        self.parent = parent
        self.children: Dict[str, "_FuncUnit"] = {}
        self.var_types: Dict[str, str] = {}   # local name -> dotted class
        # (attr, is_write, guarded, lineno) for `self.attr`
        self.accesses: List[Tuple[str, bool, bool, int]] = []
        self.calls: List[tuple] = []          # descriptors, see _Scan
        self.spawns: List[Tuple[tuple, str, int]] = []  # (target, role, line)
        self.cb_targets: List[tuple] = []     # re-rooted to MAIN_ROLE


def _module_of(relpath: str) -> str:
    mod = relpath[:-3] if relpath.endswith(".py") else relpath
    return mod.replace("/", ".")


def _resolve_imports(tree: ast.Module, module: str) -> Dict[str, str]:
    """Local name -> dotted origin, RELATIVE imports included (the tree
    imports almost everything relatively, unlike core.import_aliases)."""
    out: Dict[str, str] = {}
    pkg_parts = module.split(".")[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module or ""
            else:
                up = pkg_parts[:len(pkg_parts) - (node.level - 1)]
                base = ".".join(up + ([node.module] if node.module else []))
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{base}.{a.name}" if base \
                    else a.name
    return out


class _Scan(ast.NodeVisitor):
    """One file -> FuncUnits, class table, ownership annotations."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.module = _module_of(ctx.relpath)
        self.imports = _resolve_imports(ctx.tree, self.module)
        self.classes: Dict[ClassKey, _ClassInfo] = {}
        self.units: Dict[str, _FuncUnit] = {}
        self.cls_stack: List[ClassKey] = []
        self.lock_depth = 0
        self.owned_lines = self._scan_owned_comments()
        # the module-level pseudo-unit anchors top-level code and nesting
        self.mod_unit = self._new_unit(None, "<module>", None)
        self.unit_stack: List[_FuncUnit] = [self.mod_unit]

    # -- comments -----------------------------------------------------------
    def _scan_owned_comments(self) -> Dict[int, Tuple[str, bool]]:
        """line -> (role, has_reason) for every owned-by annotation."""
        out: Dict[int, Tuple[str, bool]] = {}
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.ctx.source).readline):
                if tok.type != tokenize.COMMENT:
                    continue
                m = _OWNED_RE.search(tok.string)
                if m:
                    out[tok.start[0]] = (m.group(1), bool(m.group(2)))
        except tokenize.TokenError:
            pass
        return out

    # -- structure ----------------------------------------------------------
    def _new_unit(self, cls: Optional[ClassKey], name: str,
                  parent: Optional[_FuncUnit],
                  is_method: bool = False) -> _FuncUnit:
        qual = f"{parent.name}.{name}" if parent is not None \
            and parent.name != "<module>" else name
        uid = f"{self.module}::{qual}"
        n = 2
        while uid in self.units:      # same-named siblings stay distinct
            uid = f"{self.module}::{qual}#{n}"
            n += 1
        u = _FuncUnit(uid, self.module, self.ctx.relpath, cls, qual, parent)
        self.units[uid] = u
        # a class METHOD is a class attribute, NOT a lexical name in the
        # enclosing function/module scope — registering it as a child
        # would let a bare `name()` call resolve to a same-named method
        # of an unrelated class and fabricate cross-thread reach
        if parent is not None and not is_method:
            parent.children[name] = u
        return u

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        bases = []
        for b in node.bases:
            d = _dotted(b)
            if d is not None:
                bases.append(self.imports.get(d.split(".")[0], d)
                             if "." not in d else d)
        is_http = any(b.split(".")[-1] == _HTTP_BASE for b in bases)
        key = (self.module, node.name)
        info = _ClassInfo(key, bases, is_http)
        self.classes[key] = info
        # class-body declarations (annotation anchor points)
        for st in node.body:
            tgt = None
            if isinstance(st, ast.AnnAssign) and isinstance(st.target,
                                                            ast.Name):
                tgt = st.target.id
            elif isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name):
                tgt = st.targets[0].id
            if tgt is not None:
                info.decl_lines.setdefault(tgt, []).append(st.lineno)
        self.cls_stack.append(key)
        # direct FunctionDef children are METHODS (class attributes, not
        # lexical names); everything else visits normally
        for st in node.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._visit_fn(st, is_method=True)
            else:
                self.visit(st)
        self.cls_stack.pop()

    def _visit_fn(self, node, is_method: bool = False) -> None:
        cls = self.cls_stack[-1] if self.cls_stack else None
        # a method's immediate parent scope for closures is the enclosing
        # FUNCTION (class bodies don't capture), so walk past a parent
        # whose unit is the class's method container: unit_stack top is it
        u = self._new_unit(cls, node.name, self.unit_stack[-1],
                           is_method=is_method)
        self._infer_param_types(node, u)
        outer_depth = self.lock_depth
        self.lock_depth = 0          # a lock held at def-time is not held at call-time
        self.unit_stack.append(u)
        for st in node.body:
            self.visit(st)
        self.unit_stack.pop()
        self.lock_depth = outer_depth

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Lambda(self, node: ast.Lambda) -> None:
        cls = self.cls_stack[-1] if self.cls_stack else None
        u = self._new_unit(cls, f"<lambda@{node.lineno}>",
                           self.unit_stack[-1])
        outer_depth = self.lock_depth
        self.lock_depth = 0
        self.unit_stack.append(u)
        self.visit(node.body)
        self.unit_stack.pop()
        self.lock_depth = outer_depth

    def _infer_param_types(self, fn, u: _FuncUnit) -> None:
        args = fn.args
        for a in list(args.args) + list(args.kwonlyargs):
            if a.annotation is not None and isinstance(a.annotation,
                                                       ast.Name):
                u.var_types[a.arg] = self.imports.get(
                    a.annotation.id, f"{self.module}.{a.annotation.id}")

    # -- guards -------------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        n_locks = 0
        for item in node.items:
            ce = item.context_expr
            name = ce.attr if isinstance(ce, ast.Attribute) else (
                ce.id if isinstance(ce, ast.Name) else None)
            if name is not None and _is_lock_name(name):
                n_locks += 1
            self.visit(ce)
        self.lock_depth += n_locks
        for st in node.body:
            self.visit(st)
        self.lock_depth -= n_locks

    visit_AsyncWith = visit_With

    # -- accesses -----------------------------------------------------------
    def _record_access(self, attr: str, is_write: bool, line: int) -> None:
        self.unit_stack[-1].accesses.append(
            (attr, is_write, self.lock_depth > 0, line))

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if self.unit_stack[-1].cls is not None:
            if isinstance(node.value, ast.Name) \
                    and node.value.id == "self":
                self._record_access(
                    node.attr, isinstance(node.ctx, (ast.Store, ast.Del)),
                    node.lineno)
            elif isinstance(node.ctx, (ast.Store, ast.Del)) \
                    and isinstance(node.value, ast.Attribute) \
                    and isinstance(node.value.value, ast.Name) \
                    and node.value.value.id == "self":
                # self.a.b = ... mutates the object self.a refers to
                self._record_access(node.value.attr, True, node.lineno)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # self.d[k] = v / del self.d[k] / self.d[k] += v mutate the
        # container the field refers to: a WRITE for sharing purposes
        # (the binding itself is only read — same view the runtime
        # sanitizer has, so the static layer must model it explicitly)
        if isinstance(node.ctx, (ast.Store, ast.Del)) \
                and self.unit_stack[-1].cls is not None \
                and isinstance(node.value, ast.Attribute) \
                and isinstance(node.value.value, ast.Name) \
                and node.value.value.id == "self":
            self._record_access(node.value.attr, True, node.lineno)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        u = self.unit_stack[-1]
        # local type evidence: x = self / x = ClassName(...)
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            tname = node.targets[0].id
            v = node.value
            if isinstance(v, ast.Name) and v.id == "self" \
                    and u.cls is not None:
                u.var_types[tname] = ".".join(u.cls)
            elif isinstance(v, ast.Call):
                d = _dotted(v.func)
                if d is not None:
                    u.var_types[tname] = self._dotted_to_class(d)
        # attr type evidence: self.x = ClassName(...) / self.x = param
        if len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Attribute) \
                and isinstance(node.targets[0].value, ast.Name) \
                and node.targets[0].value.id == "self" \
                and u.cls is not None and u.cls in self.classes:
            info = self.classes[u.cls]
            attr = node.targets[0].attr
            v = node.value
            t = None
            if isinstance(v, ast.Call):
                d = _dotted(v.func)
                if d is not None:
                    t = self._dotted_to_class(d)
            elif isinstance(v, ast.Name):
                t = u.var_types.get(v.id)
            if t is not None and attr not in info.attr_types:
                info.attr_types[attr] = t
        self.generic_visit(node)

    def _dotted_to_class(self, d: str) -> str:
        head = d.split(".")[0]
        if head in self.imports:
            return self.imports[head] + d[len(head):]
        return f"{self.module}.{d}" if "." not in d else d

    # known in-place mutators: calling one through a field is a write to
    # the object that field refers to
    _MUTATORS = frozenset({
        "append", "extend", "insert", "add", "discard", "remove", "pop",
        "popitem", "clear", "update", "setdefault", "sort", "appendleft",
        "popleft", "__setitem__", "__delitem__"})

    # -- calls / spawns / callbacks -----------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        u = self.unit_stack[-1]
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in self._MUTATORS \
                and u.cls is not None \
                and isinstance(f.value, ast.Attribute) \
                and isinstance(f.value.value, ast.Name) \
                and f.value.value.id == "self":
            self._record_access(f.value.attr, True, node.lineno)
        d = _dotted(f)
        resolved = self._dotted_to_class(d) if d else None
        if resolved in ("threading.Thread", "_thread.start_new_thread"):
            self._record_spawn(node, u)
        elif isinstance(f, ast.Attribute) \
                and f.attr in _MAIN_CALLBACK_REGS:
            idx = _MAIN_CALLBACK_REGS[f.attr]
            target = None
            if len(node.args) > idx:
                target = self._target_desc(node.args[idx])
            if target is not None:
                u.cb_targets.append(target)
        # call edges
        if isinstance(f, ast.Attribute):
            recv = f.value
            if isinstance(recv, ast.Name):
                if recv.id == "self":
                    u.calls.append(("self", f.attr))
                else:
                    u.calls.append(("var", recv.id, f.attr))
            elif isinstance(recv, ast.Attribute) \
                    and isinstance(recv.value, ast.Name) \
                    and recv.value.id == "self":
                u.calls.append(("selfattr", recv.attr, f.attr))
        elif isinstance(f, ast.Name):
            u.calls.append(("name", f.id))
        self.generic_visit(node)

    def _record_spawn(self, node: ast.Call, u: _FuncUnit) -> None:
        target = role = None
        for kw in node.keywords:
            if kw.arg == "target":
                target = self._target_desc(kw.value)
            elif kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                role = kw.value.value
        if target is None and node.args:
            target = self._target_desc(node.args[0])
        if target is None:
            return
        if role is None:
            role = target[-1]
        u.spawns.append((target, role, node.lineno))

    def _target_desc(self, expr: ast.expr) -> Optional[tuple]:
        """Resolvable thread-target/callback shapes: a bare name (local
        def or module function), ``self.meth``, or ``functools.partial``
        of either (closures and partials both reach real entry points)."""
        if isinstance(expr, ast.Name):
            return ("name", expr.id)
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name):
            if expr.value.id == "self":
                return ("self", expr.attr)
            return ("varattr", expr.value.id, expr.attr)
        if isinstance(expr, ast.Call):
            d = _dotted(expr.func)
            if d is not None \
                    and self._dotted_to_class(d) == "functools.partial" \
                    and expr.args:
                return self._target_desc(expr.args[0])
        return None


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# ---------------------------------------------------------------------------
# the cross-file analysis
# ---------------------------------------------------------------------------

class _Analysis:
    def __init__(self, scans: List[_Scan]):
        self.scans = scans
        self.units: Dict[str, _FuncUnit] = {}
        self.classes: Dict[ClassKey, _ClassInfo] = {}
        self.owned_lines: Dict[str, Dict[int, Tuple[str, bool]]] = {}
        for s in scans:
            self.units.update(s.units)
            self.classes.update(s.classes)
            self.owned_lines[s.ctx.relpath] = s.owned_lines
        # (module, fname) -> unit, and (cls, mname) -> unit
        self.mod_fns: Dict[Tuple[str, str], _FuncUnit] = {}
        self.methods: Dict[Tuple[ClassKey, str], _FuncUnit] = {}
        for u in self.units.values():
            if u.parent is not None and u.parent.name == "<module>" \
                    and u.cls is None:
                self.mod_fns[(u.module, u.name.split(".")[-1])] = u
            if u.cls is not None and "." not in u.name:
                self.methods[(u.cls, u.name)] = u
        # methods of nested classes carry qualified names; index by tail
        for u in self.units.values():
            if u.cls is not None and "." in u.name:
                key = (u.cls, u.name.split(".")[-1])
                self.methods.setdefault(key, u)

    # -- resolution ---------------------------------------------------------
    def _class_by_dotted(self, dotted: Optional[str]) -> Optional[ClassKey]:
        if not dotted or "." not in dotted:
            return None
        mod, _, cls = dotted.rpartition(".")
        key = (mod, cls)
        return key if key in self.classes else None

    def _method(self, cls: Optional[ClassKey],
                name: str) -> Optional[_FuncUnit]:
        seen: Set[ClassKey] = set()
        while cls is not None and cls not in seen:
            seen.add(cls)
            got = self.methods.get((cls, name))
            if got is not None:
                return got
            nxt = None
            for b in self.classes[cls].bases:
                bk = self._class_by_dotted(b) \
                    or self._class_by_dotted(f"{cls[0]}.{b}")
                if bk is not None:
                    nxt = bk
                    break
            cls = nxt
        return None

    def _var_type(self, u: _FuncUnit, name: str) -> Optional[str]:
        cur: Optional[_FuncUnit] = u
        while cur is not None:
            if name in cur.var_types:
                return cur.var_types[name]
            cur = cur.parent
        return None

    def _local_fn(self, u: _FuncUnit, name: str) -> Optional[_FuncUnit]:
        cur: Optional[_FuncUnit] = u
        while cur is not None:
            if name in cur.children:
                return cur.children[name]
            cur = cur.parent
        return None

    def resolve_call(self, u: _FuncUnit, call: tuple) -> Optional[_FuncUnit]:
        kind = call[0]
        if kind == "self":
            return self._method(u.cls, call[1])
        if kind == "selfattr":
            if u.cls is None or u.cls not in self.classes:
                return None
            t = self.classes[u.cls].attr_types.get(call[1])
            return self._method(self._class_by_dotted(t), call[2])
        if kind == "var":
            vt = self._var_type(u, call[1])
            if vt is not None:
                got = self._method(self._class_by_dotted(vt), call[2])
                if got is not None:
                    return got
            # module alias: eventlog.record(...)
            scan = next(s for s in self.scans if s.module == u.module)
            dotted = scan.imports.get(call[1])
            if dotted is not None:
                return self.mod_fns.get((dotted, call[2]))
            return None
        if kind == "name":
            got = self._local_fn(u, call[1])
            if got is not None:
                return got
            got = self.mod_fns.get((u.module, call[1]))
            if got is not None:
                return got
            # from-imported function or class constructor
            scan = next(s for s in self.scans if s.module == u.module)
            dotted = scan.imports.get(call[1],
                                      f"{u.module}.{call[1]}")
            ck = self._class_by_dotted(dotted)
            if ck is not None:
                return self._method(ck, "__init__")
            mod, _, fn = dotted.rpartition(".")
            return self.mod_fns.get((mod, fn))
        if kind == "varattr":   # spawn-target shape x.meth
            vt = self._var_type(u, call[1])
            return self._method(self._class_by_dotted(vt), call[2])
        return None

    # -- reachability -------------------------------------------------------
    def _reach(self, roots: List[_FuncUnit]) -> Set[str]:
        seen: Set[str] = set()
        stack = list(roots)
        while stack:
            u = stack.pop()
            if u.uid in seen:
                continue
            seen.add(u.uid)
            for c in u.calls:
                got = self.resolve_call(u, c)
                if got is not None and got.uid not in seen:
                    stack.append(got)
        return seen

    def run(self) -> Tuple[Dict[str, Set[str]], List[tuple]]:
        """-> (unit uid -> roles, annotation problems)."""
        # 1. thread entry points
        entries: List[Tuple[_FuncUnit, str]] = []
        for u in self.units.values():
            for target, role, _ in u.spawns:
                got = self.resolve_call(u, target)
                if got is not None:
                    entries.append((got, role))
        for ck, info in self.classes.items():
            if info.is_http:
                for (cls, _m), mu in list(self.methods.items()):
                    if cls == ck:
                        entries.append((mu, "http-admin"))
        # 2. per-role reach
        role_reach: Dict[str, Set[str]] = {}
        thread_units: Set[str] = set()
        for ent, role in entries:
            r = self._reach([ent])
            role_reach.setdefault(role, set()).update(r)
            thread_units |= r
        # 3. main = everything not exclusively thread-side, plus re-rooted
        # callbacks (post_action/timers run on the crank loop)
        main_roots = [u for u in self.units.values()
                      if u.uid not in thread_units]
        for u in self.units.values():
            for t in u.cb_targets:
                got = self.resolve_call(u, t)
                if got is not None:
                    main_roots.append(got)
        role_reach[MAIN_ROLE] = self._reach(main_roots)
        roles: Dict[str, Set[str]] = {}
        for role, reach in role_reach.items():
            for uid in reach:
                roles.setdefault(uid, set()).add(role)
        return roles, entries


class ThreadSafetyRule(Rule):
    id = "thread-safety"
    description = ("instance fields reachable from >=2 thread roles must "
                   "be lock-guarded or carry an owned-by annotation")

    def finalize(self, ctxs: List[FileContext]) -> Iterator[Violation]:
        scans = [_Scan(ctx) for ctx in ctxs]
        for s in scans:
            s.visit(s.ctx.tree)
        ana = _Analysis(scans)
        roles, _entries = ana.run()

        # malformed annotations are findings of their own: an attestation
        # without a reason documents nothing
        for relpath, lines in ana.owned_lines.items():
            for line, (role, has_reason) in sorted(lines.items()):
                if not has_reason:
                    yield Violation(
                        self.id, relpath, line, 0,
                        f"owned-by={role} annotation needs a reason: "
                        "`# corelint: owned-by=<role> -- reason`")

        # field table: (cls, attr) -> access rows + owning scan
        fields: Dict[Tuple[ClassKey, str], List[tuple]] = {}
        for u in ana.units.values():
            if u.cls is None:
                continue
            # any qual segment == "__init__" covers methods of classes
            # nested in functions ("build.__init__") and closures defined
            # inside __init__ ("__init__.cb" — re-rooted to main anyway)
            in_init = "__init__" in u.name.split(".")
            u_roles = roles.get(u.uid, set())
            for attr, is_write, guarded, line in u.accesses:
                if _is_lock_name(attr):
                    continue          # the guard itself is never guarded
                fields.setdefault((u.cls, attr), []).append(
                    (u, u_roles, is_write, guarded, line, in_init))

        for (cls, attr), rows in sorted(
                fields.items(), key=lambda kv: (kv[0][0], kv[0][1])):
            # __init__ accesses contribute neither roles nor findings:
            # construction happens-before thread start (init-then-publish)
            post_init = [r for r in rows if not r[5]]
            all_roles: Set[str] = set()
            for _u, r, _w, _g, _l, _init in post_init:
                all_roles |= r
            if len(all_roles) < 2:
                continue
            if not any(w for _u, _r, w, _g, _l, _i in post_init):
                continue              # init-then-publish: immutable after __init__
            if self._is_owned(ana, cls, attr, rows):
                continue
            seen_lines: Set[Tuple[str, int]] = set()
            for u, _r, is_write, guarded, line, _i in sorted(
                    post_init,
                    key=lambda r: (r[0].relpath, r[4], not r[2])):
                if guarded:
                    continue
                # one finding per line per field (a mutator call records
                # both the container write and the binding read)
                if (u.relpath, line) in seen_lines:
                    continue
                seen_lines.add((u.relpath, line))
                yield Violation(
                    self.id, u.relpath, line, 0,
                    f"field '{cls[1]}.{attr}' is shared across thread "
                    f"roles {{{', '.join(sorted(all_roles))}}} but this "
                    f"{'write' if is_write else 'read'} holds no lock — "
                    "guard it with a make_lock/make_rlock lock or annotate "
                    "`# corelint: owned-by=<role> -- reason`")

    def _is_owned(self, ana: _Analysis, cls: ClassKey, attr: str,
                  rows: List[tuple]) -> bool:
        """An owned-by annotation on any access line of the field, or on
        its class-body declaration, attests single-thread ownership."""
        info = ana.classes.get(cls)
        lines_by_rel: Dict[str, Set[int]] = {}
        for u, _r, _w, _g, line, _i in rows:
            lines_by_rel.setdefault(u.relpath, set()).add(line)
        if info is not None:
            rel = next((s.ctx.relpath for s in ana.scans
                        if s.module == cls[0]), None)
            if rel is not None:
                lines_by_rel.setdefault(rel, set()).update(
                    info.decl_lines.get(attr, []))
        for rel, lines in lines_by_rel.items():
            owned = ana.owned_lines.get(rel, {})
            if any(ln in owned and owned[ln][1] for ln in lines):
                return True
        return False


class RawLockRule(Rule):
    id = "raw-lock"
    description = ("threading.Lock()/RLock() may only be constructed in "
                   "util/lockorder.py (make_lock keeps locks nameable, "
                   "order-traced, and lockset-visible)")

    ALLOWED = "util/lockorder.py"

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if path_is(ctx.relpath, self.ALLOWED):
            return
        imports = _resolve_imports(ctx.tree, _module_of(ctx.relpath))
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            if d is None:
                continue
            head = d.split(".")[0]
            resolved = imports.get(head, head) + d[len(head):]
            if resolved in ("threading.Lock", "threading.RLock"):
                kind = resolved.split(".")[-1]
                yield Violation(
                    self.id, ctx.relpath, node.lineno, node.col_offset,
                    f"raw threading.{kind}() — route it through "
                    f"util.lockorder.make_{'r' if kind == 'RLock' else ''}"
                    "lock(name) so the lock is order-traced and visible "
                    "to the race sanitizer's lockset")
