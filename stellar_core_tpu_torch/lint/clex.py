"""Hand-rolled C lexer for corelint's native-C rules (no pycparser).

The 10.4k-line native engine (native/*.c) is load-bearing for live close
and replay, so the same static-analysis bar the Python tree has must
cover it.  Full C parsing is out of scope (and pycparser is not in the
image); the rules in rules/native_c.py only need:

  - a token stream with line numbers (comments/strings/char literals
    stripped into single tokens, preprocessor directives skipped),
  - brace-matched top-level function extraction (name, parameter tokens,
    body token slice),
  - the corelint suppression grammar in C comments:
        /* corelint: disable=<rule>[,<rule>...] -- reason */
        /* corelint: disable-file=<rule>[,...] -- reason */

Deliberately NOT handled: K&R definitions, digraphs/trigraphs, nested
function-type declarators in parameter lists beyond what the engine
uses.  A brace-unbalanced file raises CParseError, which the runner
reports as a parse error (fail-stop, never a silent green).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

_C_SUPPRESS_RE = re.compile(
    r"corelint:\s*(disable(?:-file)?)\s*=\s*([a-z0-9_,\s-]+?)"
    r"(?:\s*--.*)?$", re.DOTALL)

# longest-match punctuation (3-char before 2-char before 1-char)
_PUNCT3 = ("<<=", ">>=", "...")
_PUNCT2 = ("->", "<<", ">>", "<=", ">=", "==", "!=", "&&", "||",
           "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "++", "--")

_NAME_START = set("abcdefghijklmnopqrstuvwxyz"
                  "ABCDEFGHIJKLMNOPQRSTUVWXYZ_")
_NAME_CONT = _NAME_START | set("0123456789")
_DIGITS = set("0123456789")


class CParseError(ValueError):
    """Lexing/brace-matching failure — reported as a lint parse error."""

    def __init__(self, msg: str, line: int):
        super().__init__(f"line {line}: {msg}")
        self.line = line


@dataclass(frozen=True)
class Tok:
    kind: str       # "name" | "num" | "str" | "char" | "punct"
    text: str
    line: int
    col: int

    def __repr__(self) -> str:  # compact for test failure output
        return f"{self.kind}:{self.text}@{self.line}"


@dataclass
class CFunction:
    """One brace-matched function definition."""
    name: str
    line: int                   # line of the function name token
    params: List[Tok]           # tokens inside the parameter parens
    body: List[Tok]             # tokens inside the outermost braces
                                # (braces themselves excluded)

    def param_names_of_type(self, type_name: str) -> Set[str]:
        """Names of parameters declared with `type_name` (pointer or
        value, const-qualified or not): `Rd *r`, `const Rd *outer`."""
        out: Set[str] = set()
        toks = self.params
        for i, t in enumerate(toks):
            if t.kind == "name" and t.text == type_name:
                j = i + 1
                while j < len(toks) and toks[j].text in ("*", "const"):
                    j += 1
                if j < len(toks) and toks[j].kind == "name":
                    out.add(toks[j].text)
        return out

    def local_names_of_type(self, type_name: str) -> Set[str]:
        """Names declared in the body as `type_name x;` / `type_name *x`
        (comma lists included: `Rd a, b;`)."""
        out: Set[str] = set()
        toks = self.body
        i = 0
        while i < len(toks):
            t = toks[i]
            if t.kind == "name" and t.text == type_name and \
                    (i == 0 or toks[i - 1].text in (";", "{", "}")
                     or toks[i - 1].text in ("const", "static")):
                j = i + 1
                while j < len(toks) and toks[j].text != ";":
                    while j < len(toks) and toks[j].text in ("*", "const"):
                        j += 1
                    if j < len(toks) and toks[j].kind == "name":
                        out.add(toks[j].text)
                        j += 1
                    # skip to next ',' or ';' (array dims, initializers)
                    depth = 0
                    while j < len(toks):
                        x = toks[j].text
                        if x in ("(", "["):
                            depth += 1
                        elif x in (")", "]"):
                            depth -= 1
                        elif depth == 0 and x in (",", ";"):
                            break
                        j += 1
                    if j < len(toks) and toks[j].text == ",":
                        j += 1
                        continue
                    break
                i = j
            i += 1
        return out


def tokenize(source: str) -> Tuple[List[Tok], List[Tuple[int, str]]]:
    """Return (tokens, comments) where comments is [(start_line, text)].
    Preprocessor directives (with backslash continuations) are skipped;
    string/char literals become single tokens."""
    toks: List[Tok] = []
    comments: List[Tuple[int, str]] = []
    i, n = 0, len(source)
    line, col = 1, 1
    at_line_start = True

    def adv(k: int) -> None:
        nonlocal i, line, col
        for _ in range(k):
            if i < n and source[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        c = source[i]
        if c in " \t\r":
            adv(1)
            continue
        if c == "\n":
            adv(1)
            at_line_start = True
            continue
        if at_line_start and c == "#":
            # preprocessor directive: consume to EOL, honoring \-continuations
            while i < n:
                if source[i] == "\\" and i + 1 < n and source[i + 1] == "\n":
                    adv(2)
                    continue
                if source[i] == "\n":
                    break
                adv(1)
            continue
        at_line_start = False
        if c == "/" and i + 1 < n and source[i + 1] == "*":
            start_line = line
            j = source.find("*/", i + 2)
            if j < 0:
                raise CParseError("unterminated block comment", start_line)
            comments.append((start_line, source[i + 2:j]))
            adv(j + 2 - i)
            continue
        if c == "/" and i + 1 < n and source[i + 1] == "/":
            start_line = line
            j = source.find("\n", i)
            j = n if j < 0 else j
            comments.append((start_line, source[i + 2:j]))
            adv(j - i)
            continue
        if c in ('"', "'"):
            quote, start_line, start_col = c, line, col
            j = i + 1
            while j < n:
                if source[j] == "\\":
                    j += 2
                    continue
                if source[j] == quote:
                    break
                if source[j] == "\n" and quote == '"':
                    raise CParseError("unterminated string literal",
                                      start_line)
                j += 1
            if j >= n:
                raise CParseError("unterminated literal", start_line)
            text = source[i:j + 1]
            toks.append(Tok("str" if quote == '"' else "char", text,
                            start_line, start_col))
            adv(j + 1 - i)
            continue
        if c in _NAME_START:
            j = i + 1
            while j < n and source[j] in _NAME_CONT:
                j += 1
            toks.append(Tok("name", source[i:j], line, col))
            adv(j - i)
            continue
        if c in _DIGITS:
            j = i + 1
            if c == "0" and j < n and source[j] in "xX":
                j += 1
                while j < n and source[j] in "0123456789abcdefABCDEF":
                    j += 1
            else:
                while j < n and source[j] in "0123456789.":
                    j += 1
            while j < n and source[j] in "uUlLfF":
                j += 1
            toks.append(Tok("num", source[i:j], line, col))
            adv(j - i)
            continue
        three, two = source[i:i + 3], source[i:i + 2]
        if three in _PUNCT3:
            toks.append(Tok("punct", three, line, col))
            adv(3)
            continue
        if two in _PUNCT2:
            toks.append(Tok("punct", two, line, col))
            adv(2)
            continue
        toks.append(Tok("punct", c, line, col))
        adv(1)
    return toks, comments


def extract_functions(toks: List[Tok]) -> List[CFunction]:
    """Brace-matched top-level function extraction.  A `{` at file scope
    whose previous token is `)` opens a function body; any other
    file-scope brace group (initializer, struct/enum/union definition)
    is skipped wholesale."""
    funcs: List[CFunction] = []
    i, n = 0, len(toks)
    while i < n:
        if toks[i].text != "{" or toks[i].kind != "punct":
            i += 1
            continue
        # match the brace group first (shared by both arms)
        depth, j = 1, i + 1
        while j < n and depth:
            if toks[j].kind == "punct":
                if toks[j].text == "{":
                    depth += 1
                elif toks[j].text == "}":
                    depth -= 1
            j += 1
        if depth:
            raise CParseError("unbalanced braces", toks[i].line)
        prev = toks[i - 1] if i > 0 else None
        if prev is not None and prev.kind == "punct" and prev.text == ")":
            # walk back to the matching '(' for the parameter list
            pdepth, k = 1, i - 2
            while k >= 0 and pdepth:
                if toks[k].kind == "punct":
                    if toks[k].text == ")":
                        pdepth += 1
                    elif toks[k].text == "(":
                        pdepth -= 1
                if pdepth:
                    k -= 1
            name_tok = toks[k - 1] if k > 0 else None
            if name_tok is not None and name_tok.kind == "name":
                funcs.append(CFunction(
                    name=name_tok.text,
                    line=name_tok.line,
                    params=toks[k + 1:i - 1],
                    body=toks[i + 1:j - 1]))
        i = j
    return funcs


class CFileContext:
    """C analogue of lint.core.FileContext: one lexed source file plus
    its suppression tables.  `language` routes rule dispatch; the
    suppression protocol (is_suppressed) matches FileContext exactly so
    reporting and the baseline ratchet are shared."""

    language = "c"
    tree = None     # no Python AST

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.tokens, self.comments = tokenize(source)
        self.functions = extract_functions(self.tokens)
        self.line_suppressions: Dict[int, Set[str]] = {}
        self.file_suppressions: Set[str] = set()
        self._scan_comments()

    def _scan_comments(self) -> None:
        for start_line, text in self.comments:
            m = _C_SUPPRESS_RE.search(text.strip())
            if not m:
                continue
            rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
            if m.group(1) == "disable-file":
                self.file_suppressions |= rules
            else:
                self.line_suppressions.setdefault(
                    start_line, set()).update(rules)

    def is_suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_suppressions:
            return True
        return rule in self.line_suppressions.get(line, set())


# ---------------------------------------------------------------------------
# Token-slice helpers shared by the native-C rules
# ---------------------------------------------------------------------------

def find_calls(toks: List[Tok], names: Set[str]) -> List[Tuple[int, str]]:
    """Indexes (into toks) of call sites `name (` for any name in
    `names`.  Declarations are excluded by requiring the previous token
    not to be a type-ish name is NOT attempted — the engine never
    declares functions with these names locally."""
    out: List[Tuple[int, str]] = []
    for i, t in enumerate(toks):
        if t.kind == "name" and t.text in names and i + 1 < len(toks) \
                and toks[i + 1].text == "(":
            out.append((i, t.text))
    return out


def call_args(toks: List[Tok], open_paren: int) -> List[List[Tok]]:
    """Split the argument tokens of a call whose '(' is at `open_paren`
    into top-level comma-separated slices."""
    args: List[List[Tok]] = []
    cur: List[Tok] = []
    depth = 1
    i = open_paren + 1
    while i < len(toks) and depth:
        t = toks[i]
        if t.kind == "punct":
            if t.text in ("(", "["):
                depth += 1
            elif t.text in (")", "]"):
                depth -= 1
                if depth == 0:
                    break
            elif t.text == "," and depth == 1:
                args.append(cur)
                cur = []
                i += 1
                continue
        cur.append(t)
        i += 1
    if cur or args:
        args.append(cur)
    return args


def text_of(toks: List[Tok]) -> str:
    return " ".join(t.text for t in toks)
