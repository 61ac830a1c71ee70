"""Native-C engine discipline rules.

The C engine (native/capply.c, cxdr.c, cquorum.c) computes authoritative
ledger hashes; these rules enforce its own established memory idioms
tree-wide, over the clex.py token/function representation:

  reader-discipline           all XDR consumption goes through the
                              bounds-checked rd_* helpers; raw access to
                              a reader's buffer pointer outside them fires
  memcpy-provenance           every memcpy length is a constant, sizeof-
                              derived, or provably bounded (rd_varopaque/
                              rd_take binding or a matching allocation)
  unchecked-alloc             every malloc/calloc/realloc result is
                              null-checked before first use
  handler-result-discipline   every op_* handler return path writes an op
                              result code into the result Buf (or is the
                              -1 engine-error path) — the C analogue of
                              ledger-txn-paths
  overlay-pairing             per-op / path-hop rollback-overlay pushes
                              (op_active/hop_active = 1) are popped on
                              every return path (CAP-33 sandwich code)

Suppress with ``/* corelint: disable=<rule> -- reason */`` on the
flagged line; suppressions ratchet through the lint baseline exactly
like the Python rules.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from ..clex import CFileContext, Tok, call_args, find_calls
from ..core import Rule, Violation

# allocators whose raw result must be null-checked / may size a copy
_ALLOC_FNS = {"PyMem_Malloc", "PyMem_Calloc", "PyMem_Realloc",
              "PyMem_RawMalloc", "malloc", "calloc", "realloc"}
# bounded-buffer constructors: an argument list naming the copied length
# proves the destination was sized by the same expression
_SIZED_FNS = _ALLOC_FNS | {"rb_new", "buf_reserve"}
# op-result writers (handler-result-discipline)
_RESULT_WRITERS = {"res_inner", "res_outer", "sponsorship_error_c",
                   "tx_result_void", "tx_result_ops"}
# calls that reset every rollback-overlay flag (overlay-pairing)
_OVERLAY_RESETTERS = {"eng_rollback_tx"}
_OVERLAY_FLAGS = ("op_active", "hop_active")

_C_KEYWORDS = {
    "if", "else", "for", "while", "do", "switch", "case", "default",
    "return", "goto", "break", "continue", "sizeof", "struct", "union",
    "enum", "typedef", "static", "const", "void", "int", "char", "long",
    "short", "unsigned", "signed", "float", "double", "volatile",
    "register", "extern", "inline",
}

_CONST_PUNCT = {"+", "-", "*", "/", "%", "(", ")", "<<", ">>",
                "&", "|", "^", "~"}


class _CRule(Rule):
    """Base: dispatch only on lexed C files."""

    language = "c"


def _texts(toks: List[Tok]) -> List[str]:
    return [t.text for t in toks]


def _is_subseq(needle: List[str], hay: List[str]) -> bool:
    n = len(needle)
    if n == 0:
        return False
    return any(hay[i:i + n] == needle for i in range(len(hay) - n + 1))


def _is_member_chain(toks: List[Tok]) -> bool:
    """`x`, `x->y`, `x.y->z` — a single lvalue chain."""
    if not toks or toks[0].kind != "name":
        return False
    expect_name = False
    for t in toks[1:]:
        if expect_name:
            if t.kind != "name":
                return False
            expect_name = False
        elif t.kind == "punct" and t.text in ("->", "."):
            expect_name = True
        else:
            return False
    return not expect_name


def _is_const_expr(toks: List[Tok]) -> bool:
    """Numbers and arithmetic punctuation only (`4`, `4 + 32`, `40 + n`
    is NOT const)."""
    if not toks:
        return False
    for t in toks:
        if t.kind == "num":
            continue
        if t.kind == "punct" and t.text in _CONST_PUNCT:
            continue
        return False
    return True


def _split_ternary(toks: List[Tok]) -> Optional[Tuple[List[Tok], List[Tok]]]:
    """For a top-level `c ? a : b` return (a, b) else None."""
    depth = 0
    qpos = -1
    for i, t in enumerate(toks):
        if t.kind != "punct":
            continue
        if t.text in ("(", "["):
            depth += 1
        elif t.text in (")", "]"):
            depth -= 1
        elif t.text == "?" and depth == 0:
            qpos = i
            break
    if qpos < 0:
        return None
    depth = 0
    for i in range(qpos + 1, len(toks)):
        t = toks[i]
        if t.kind != "punct":
            continue
        if t.text in ("(", "["):
            depth += 1
        elif t.text in (")", "]"):
            depth -= 1
        elif t.text == ":" and depth == 0:
            return toks[qpos + 1:i], toks[i + 1:]
    return None


# ---------------------------------------------------------------------------
# reader-discipline
# ---------------------------------------------------------------------------

class ReaderDisciplineRule(_CRule):
    id = "reader-discipline"
    description = "XDR reader buffers consumed only via rd_* helpers " \
                  "(no raw `.p` pointer arithmetic outside them)"

    def check(self, ctx) -> Iterator[Violation]:
        if not isinstance(ctx, CFileContext):
            return
        for fn in ctx.functions:
            if fn.name.startswith("rd_"):
                continue            # the helpers ARE the blessed accessors
            rd_vars = fn.param_names_of_type("Rd") \
                | fn.local_names_of_type("Rd")
            if not rd_vars:
                continue
            body = fn.body
            for i, t in enumerate(body):
                if t.kind != "name" or t.text not in rd_vars:
                    continue
                if i + 2 < len(body) \
                        and body[i + 1].kind == "punct" \
                        and body[i + 1].text in (".", "->") \
                        and body[i + 2].kind == "name" \
                        and body[i + 2].text == "p" \
                        and (i == 0 or body[i - 1].text
                             not in (".", "->")):
                    yield Violation(
                        self.id, ctx.relpath, t.line, t.col,
                        f"raw access to XDR reader buffer "
                        f"`{t.text}{body[i + 1].text}p` in {fn.name}() — "
                        f"consume via the bounds-checked rd_take/"
                        f"rd_varopaque helpers")


# ---------------------------------------------------------------------------
# memcpy-provenance
# ---------------------------------------------------------------------------

class MemcpyProvenanceRule(_CRule):
    id = "memcpy-provenance"
    description = "memcpy lengths are constants, sizeof-derived, or " \
                  "bounded by a preceding rd_varopaque/rd_take or " \
                  "matching allocation"

    def check(self, ctx) -> Iterator[Violation]:
        if not isinstance(ctx, CFileContext):
            return
        for fn in ctx.functions:
            body = fn.body
            for idx, _name in find_calls(body, {"memcpy"}):
                args = call_args(body, idx + 1)
                if len(args) != 3:
                    continue        # macro-ish or variadic: out of scope
                length = args[2]
                if self._length_ok(length, body, idx):
                    continue
                t = body[idx]
                yield Violation(
                    self.id, ctx.relpath, t.line, t.col,
                    f"memcpy length `{' '.join(_texts(length))}` in "
                    f"{fn.name}() is neither constant, sizeof-derived, "
                    f"nor bounded by a preceding rd_varopaque/rd_take "
                    f"or same-length allocation in this function")

    def _length_ok(self, length: List[Tok], body: List[Tok],
                   call_idx: int) -> bool:
        if any(t.kind == "name" and t.text == "sizeof" for t in length):
            return True
        if _is_const_expr(length):
            return True
        arms = _split_ternary(length)
        if arms is not None and _is_const_expr(arms[0]) \
                and _is_const_expr(arms[1]):
            return True
        if not _is_member_chain(length):
            return False
        want = _texts(length)
        # provenance scan over the tokens BEFORE this memcpy
        prefix = body[:call_idx]
        for i, name in find_calls(prefix, {"rd_varopaque", "rd_take"}
                                  | _SIZED_FNS):
            args = call_args(prefix, i + 1)
            if name == "rd_varopaque":
                # rd_varopaque(r, MAX, &len): the out-param IS the bound
                if len(args) == 3 and _texts(args[2]) == ["&"] + want:
                    return True
            elif name == "rd_take":
                # rd_take(r, n) bounds n bytes of the source
                if len(args) == 2 and _texts(args[1]) == want:
                    return True
            else:
                # destination sized by the same expression
                flat: List[str] = []
                for a in args:
                    flat.extend(_texts(a))
                    flat.append(",")
                if _is_subseq(want, flat):
                    return True
        return False


# ---------------------------------------------------------------------------
# unchecked-alloc
# ---------------------------------------------------------------------------

class UncheckedAllocRule(_CRule):
    id = "unchecked-alloc"
    description = "every malloc/calloc/realloc result is null-checked " \
                  "before first use"

    def check(self, ctx) -> Iterator[Violation]:
        if not isinstance(ctx, CFileContext):
            return
        for fn in ctx.functions:
            body = fn.body
            for idx, name in find_calls(body, _ALLOC_FNS):
                t = body[idx]
                lv = self._lvalue_before(body, idx)
                if lv is None:
                    yield Violation(
                        self.id, ctx.relpath, t.line, t.col,
                        f"{name}() result in {fn.name}() is not stored "
                        f"in a checkable lvalue — assign it and "
                        f"null-check before use")
                    continue
                problem = self._first_use_unchecked(body, idx, lv)
                if problem:
                    yield Violation(
                        self.id, ctx.relpath, t.line, t.col,
                        f"{name}() result `{' '.join(lv)}` in "
                        f"{fn.name}() is {problem}")

    @staticmethod
    def _lvalue_before(body: List[Tok], idx: int) -> Optional[List[str]]:
        """For `<lvalue> = alloc(...)` return the lvalue token texts."""
        if idx == 0 or body[idx - 1].text != "=":
            return None
        j = idx - 2
        chain: List[str] = []
        while j >= 0:
            t = body[j]
            if t.kind == "name" or (t.kind == "punct"
                                    and t.text in (".", "->")):
                chain.append(t.text)
                j -= 1
                continue
            break
        chain.reverse()
        if not chain or chain[0] in ("->", "."):
            return None
        return chain

    @staticmethod
    def _first_use_unchecked(body: List[Tok], call_idx: int,
                             lv: List[str]) -> Optional[str]:
        # skip to the end of the allocation statement
        depth = 0
        i = call_idx
        while i < len(body):
            x = body[i].text
            if body[i].kind == "punct":
                if x in ("(", "[", "{"):
                    depth += 1
                elif x in (")", "]", "}"):
                    depth -= 1
                elif x == ";" and depth == 0:
                    break
            i += 1
        i += 1
        n = len(lv)
        texts = [t.text for t in body]
        while i < len(body) - n + 1:
            if texts[i:i + n] == lv:
                # a longer member chain starting with the same prefix is
                # a USE of the object, not the pointer check we need —
                # unless guarded by `!` / `== NULL` / `!= NULL`
                prev = body[i - 1].text if i > 0 else ""
                nxt = body[i + n].text if i + n < len(body) else ""
                nxt2 = body[i + n + 1].text if i + n + 1 < len(body) else ""
                if prev in (".", "->"):
                    i += 1
                    continue        # member of a different chain
                if prev == "!" and nxt not in (".", "->"):
                    return None
                if nxt in ("==", "!=") and nxt2 in ("NULL", "0"):
                    return None
                # plain truthiness guards: `if (p)`, `while (p)`,
                # `if (x || p)`, `p ? a : b` — but NOT `f(p)`, which is
                # a use (prev '(' only counts under an if/while keyword)
                prev2 = body[i - 2].text if i > 1 else ""
                if prev == "(" and prev2 in ("if", "while") \
                        and nxt not in (".", "->", "["):
                    return None
                if prev in ("&&", "||") and nxt not in (".", "->", "["):
                    return None
                if nxt == "?":
                    return None
                return "used before a null check " \
                       f"(first use at line {body[i].line})"
            i += 1
        return "never null-checked in this function"


# ---------------------------------------------------------------------------
# handler-result-discipline
# ---------------------------------------------------------------------------

class HandlerResultRule(_CRule):
    id = "handler-result-discipline"
    description = "every op_* handler return path writes an op result " \
                  "code into the result Buf (or returns -1 engine error)"

    # A "result write" is a res_* writer call OR any call that receives
    # the handler's result-Buf parameter (delegation: store_trustline,
    # apply_manage_c, convert_hop_c and the success-arm buf_* writes all
    # take `rb`).  A return path is clean when its expression contains a
    # write / a write-derived variable / is the `-1` engine-error path;
    # a bare-constant return is additionally accepted when a result
    # write appears textually earlier in the function (the success-arm
    # idiom: write the arm, then `return 1;`).  That prefix check is
    # path-INsensitive by design — a branch-local miss needs the runtime
    # differential tier; this rule catches the structural omission.

    def check(self, ctx) -> Iterator[Violation]:
        if not isinstance(ctx, CFileContext):
            return
        for fn in ctx.functions:
            if not fn.name.startswith("op_"):
                continue
            bufs = fn.param_names_of_type("Buf")
            if not bufs:
                continue            # no result buffer: not a handler
            written_vars = self._result_vars(fn.body, bufs)
            for expr, line, col, idx in self._returns(fn.body):
                if self._return_ok(expr, written_vars, bufs):
                    continue
                if self._writes_result(fn.body[:idx], bufs):
                    continue        # success-arm idiom: write, then return
                yield Violation(
                    self.id, ctx.relpath, line, col,
                    f"{fn.name}() returns `{' '.join(_texts(expr))}` "
                    f"without writing an op result — every early-return "
                    f"path must res_inner() into the result Buf or "
                    f"return -1 (engine error)")

    @staticmethod
    def _writes_result(toks: List[Tok], bufs: Set[str]) -> bool:
        """True when `toks` contain a result write: a writer-helper call
        or any call taking the result Buf as an argument."""
        for i, t in enumerate(toks):
            if t.kind != "name" or i + 1 >= len(toks) \
                    or toks[i + 1].text != "(":
                continue
            if t.text in _RESULT_WRITERS:
                return True
            for arg in call_args(toks, i + 1):
                if any(a.kind == "name" and a.text in bufs
                       and (k == 0 or arg[k - 1].text not in (".", "->"))
                       for k, a in enumerate(arg)):
                    return True
        return False

    def _result_vars(self, body: List[Tok], bufs: Set[str]) -> Set[str]:
        """Variables assigned from a result-writing expression
        (`rc = res_inner(...)`, `rc2 = payment_tl_side(e, rb, ...)`),
        one transitive hop per pass."""
        out: Set[str] = set()
        for _pass in range(3):
            grew = False
            for i, t in enumerate(body):
                if t.kind != "name" or i + 1 >= len(body) \
                        or body[i + 1].text != "=":
                    continue
                j = i + 2
                rhs: List[Tok] = []
                depth = 0
                while j < len(body):
                    x = body[j]
                    if x.kind == "punct":
                        if x.text in ("(", "[", "{"):
                            depth += 1
                        elif x.text in (")", "]", "}"):
                            depth -= 1
                        elif x.text == ";" and depth == 0:
                            break
                    rhs.append(x)
                    j += 1
                if t.text in out:
                    continue
                if any(r.kind == "name" and r.text in out for r in rhs) \
                        or self._writes_result(rhs, bufs):
                    out.add(t.text)
                    grew = True
            if not grew:
                break
        return out

    @staticmethod
    def _returns(body: List[Tok]) \
            -> Iterator[Tuple[List[Tok], int, int, int]]:
        i = 0
        while i < len(body):
            t = body[i]
            if t.kind == "name" and t.text == "return":
                j = i + 1
                expr: List[Tok] = []
                depth = 0
                while j < len(body):
                    x = body[j]
                    if x.kind == "punct":
                        if x.text in ("(", "[", "{"):
                            depth += 1
                        elif x.text in (")", "]", "}"):
                            depth -= 1
                        elif x.text == ";" and depth == 0:
                            break
                    expr.append(x)
                    j += 1
                yield expr, t.line, t.col, i
                i = j
            i += 1

    def _return_ok(self, expr: List[Tok], written_vars: Set[str],
                   bufs: Set[str]) -> bool:
        if _texts(expr) == ["-", "1"]:
            return True             # engine-error path: caller aborts tx
        for t in expr:
            if t.kind == "name" and t.text in written_vars:
                return True
        return self._writes_result(expr, bufs)


# ---------------------------------------------------------------------------
# overlay-pairing
# ---------------------------------------------------------------------------

# statement-tree nodes for the path simulation
_TERMINATORS = ("return", "goto", "break", "continue")


class OverlayPairingRule(_CRule):
    id = "overlay-pairing"
    description = "rollback-overlay pushes (op_active/hop_active = 1) " \
                  "balance with a pop on every return path"

    def check(self, ctx) -> Iterator[Violation]:
        if not isinstance(ctx, CFileContext):
            return
        for fn in ctx.functions:
            if not self._pushes_overlay(fn.body):
                continue
            try:
                nodes, _ = self._parse_block(fn.body, 0, len(fn.body))
            except IndexError:
                continue            # malformed body: lexer already errs
            found: Set[Tuple[int, int, str]] = set()
            self._eval(nodes, frozenset({(0, 0)}), found, [])
            for line, col, flag in sorted(found):
                yield Violation(
                    self.id, ctx.relpath, line, col,
                    f"{fn.name}() can return with the {flag} rollback "
                    f"overlay still pushed — every return path must "
                    f"reset {flag} = 0 (or eng_rollback_tx) first")

    @staticmethod
    def _pushes_overlay(body: List[Tok]) -> bool:
        for i, t in enumerate(body):
            if t.kind == "name" and t.text in _OVERLAY_FLAGS \
                    and i + 2 < len(body) and body[i + 1].text == "=" \
                    and body[i + 2].text == "1":
                return True
        return False

    # -- statement-tree parser ------------------------------------------

    def _parse_block(self, toks: List[Tok], i: int, end: int):
        nodes = []
        while i < end:
            node, i = self._parse_stmt(toks, i, end)
            if node is not None:
                nodes.append(node)
        return nodes, i

    def _parse_stmt(self, toks: List[Tok], i: int, end: int):
        t = toks[i]
        if t.kind == "punct" and t.text == ";":
            return None, i + 1
        if t.kind == "punct" and t.text == "{":
            close = self._match(toks, i, end)
            nodes, _ = self._parse_block(toks, i + 1, close)
            return ("block", nodes), close + 1
        if t.kind == "name":
            kw = t.text
            if kw == "if":
                cclose = self._match(toks, i + 1, end)
                then, i2 = self._parse_stmt(toks, cclose + 1, end)
                els = None
                if i2 < end and toks[i2].kind == "name" \
                        and toks[i2].text == "else":
                    els, i2 = self._parse_stmt(toks, i2 + 1, end)
                return ("if", then, els), i2
            if kw in ("for", "while"):
                cclose = self._match(toks, i + 1, end)
                body, i2 = self._parse_stmt(toks, cclose + 1, end)
                return ("loop", body), i2
            if kw == "do":
                body, i2 = self._parse_stmt(toks, i + 1, end)
                # consume `while ( ... ) ;`
                if i2 < end and toks[i2].text == "while":
                    cclose = self._match(toks, i2 + 1, end)
                    i2 = cclose + 1
                    if i2 < end and toks[i2].text == ";":
                        i2 += 1
                return ("loop", body), i2
            if kw == "switch":
                cclose = self._match(toks, i + 1, end)
                body, i2 = self._parse_stmt(toks, cclose + 1, end)
                return ("switch", body), i2
            if kw in ("case", "default"):
                j = i + 1
                depth = 0
                while j < end:
                    x = toks[j]
                    if x.kind == "punct":
                        if x.text in ("(", "["):
                            depth += 1
                        elif x.text in (")", "]"):
                            depth -= 1
                        elif x.text == ":" and depth == 0:
                            break
                    j += 1
                return None, j + 1
            if kw in _TERMINATORS:
                j = i + 1
                depth = 0
                while j < end:
                    x = toks[j]
                    if x.kind == "punct":
                        if x.text in ("(", "[", "{"):
                            depth += 1
                        elif x.text in (")", "]", "}"):
                            depth -= 1
                        elif x.text == ";" and depth == 0:
                            break
                    j += 1
                return (kw, toks[i:j], t.line, t.col), j + 1
            # label? `name :` at statement start (not `? :` ternary)
            if i + 1 < end and toks[i + 1].kind == "punct" \
                    and toks[i + 1].text == ":" \
                    and kw not in _C_KEYWORDS:
                return None, i + 2
        # simple statement: consume to ';' at depth 0
        j = i
        depth = 0
        while j < end:
            x = toks[j]
            if x.kind == "punct":
                if x.text in ("(", "[", "{"):
                    depth += 1
                elif x.text in (")", "]", "}"):
                    depth -= 1
                elif x.text == ";" and depth == 0:
                    break
            j += 1
        return ("simple", toks[i:j]), j + 1

    @staticmethod
    def _match(toks: List[Tok], open_idx: int, end: int) -> int:
        """Index of the close matching the opener at open_idx (which
        must be '(' or '{')."""
        opener = toks[open_idx].text
        close = {"(": ")", "{": "}"}[opener]
        depth = 1
        j = open_idx + 1
        while j < end:
            x = toks[j]
            if x.kind == "punct":
                if x.text == opener:
                    depth += 1
                elif x.text == close:
                    depth -= 1
                    if depth == 0:
                        return j
            j += 1
        raise IndexError("unmatched bracket")

    # -- path simulation -------------------------------------------------

    def _eval(self, nodes, state: FrozenSet[Tuple[int, int]],
              found: Set[Tuple[int, int, str]], break_stack) \
            -> Tuple[FrozenSet[Tuple[int, int]], bool]:
        """Returns (out_state, terminated)."""
        for node in nodes:
            state, term = self._eval_node(node, state, found, break_stack)
            if term:
                return state, True
        return state, False

    def _eval_node(self, node, state, found, break_stack):
        kind = node[0]
        if kind == "simple":
            return self._apply_effects(node[1], state), False
        if kind == "block":
            return self._eval(node[1], state, found, break_stack)
        if kind == "if":
            then_s, then_t = self._eval_opt(node[1], state, found,
                                            break_stack)
            else_s, else_t = self._eval_opt(node[2], state, found,
                                            break_stack)
            outs = set()
            if not then_t:
                outs |= then_s
            if not else_t:
                outs |= else_s
            if then_t and else_t:
                return state, True
            return frozenset(outs), False
        if kind in ("loop", "switch"):
            break_stack.append(set())
            s1, t1 = self._eval_opt(node[1], state, found, break_stack)
            merged = set(state)
            if not t1:
                merged |= s1
            if kind == "loop":
                s2, t2 = self._eval_opt(node[1], frozenset(merged), found,
                                        break_stack)
                if not t2:
                    merged |= s2
            merged |= break_stack.pop()
            return frozenset(merged), False
        if kind in ("return", "goto"):
            _, toks, line, col = node
            for st in state:
                for flag, val in zip(_OVERLAY_FLAGS, st):
                    if val == 1:
                        found.add((line, col, flag))
            return state, True
        if kind in ("break", "continue"):
            _, toks, line, col = node
            if break_stack:
                break_stack[-1] |= set(state)
            return state, True
        return state, False

    def _eval_opt(self, node, state, found, break_stack):
        if node is None:
            return state, False
        return self._eval_node(node, state, found, break_stack)

    @staticmethod
    def _apply_effects(toks: List[Tok],
                       state: FrozenSet[Tuple[int, int]]):
        sets: Dict[str, Optional[int]] = {}
        for i, t in enumerate(toks):
            if t.kind == "name" and t.text in _OVERLAY_RESETTERS \
                    and i + 1 < len(toks) and toks[i + 1].text == "(":
                for f in _OVERLAY_FLAGS:
                    sets[f] = 0
            if t.kind == "name" and t.text in _OVERLAY_FLAGS \
                    and i + 1 < len(toks) and toks[i + 1].kind == "punct" \
                    and toks[i + 1].text == "=":
                # chained assigns end with the final value token
                last = toks[-1]
                if last.kind == "num" and last.text in ("0", "1"):
                    sets[t.text] = int(last.text)
                else:
                    sets[t.text] = None       # unknown: both values
        if not sets:
            return state
        out = set()
        for op_v, hop_v in state:
            vals = {"op_active": [op_v], "hop_active": [hop_v]}
            for f, v in sets.items():
                vals[f] = [0, 1] if v is None else [v]
            for a in vals["op_active"]:
                for b in vals["hop_active"]:
                    out.add((a, b))
        return frozenset(out)


NATIVE_C_RULE_CLASSES = (
    ReaderDisciplineRule,
    MemcpyProvenanceRule,
    UncheckedAllocRule,
    HandlerResultRule,
    OverlayPairingRule,
)
