"""corelint framework: AST rule registry, suppressions, reporters, ratchet.

Reference shape: the reference codebase's invariant/SelfCheck machinery
applied at *compile* time — each Rule encodes one repo discipline (clock,
LedgerTxn hygiene, the decode-free seam, lock order, metric naming) and
the runner turns a source tree into a machine-checkable report.

Suppressions:
  ``# corelint: disable=<rule>[,<rule>...] [-- reason]`` on the flagged
  line suppresses those rules for that line;
  ``# corelint: disable-file=<rule>[,...]`` anywhere in a file suppresses
  the rules for the whole file.
Suppressed findings are not dropped — they are reported in a separate
``suppressed`` list and ratcheted by the committed baseline, so adding a
new suppression is as visible as adding a violation.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

_SUPPRESS_RE = re.compile(
    r"#\s*corelint:\s*(disable(?:-file)?)\s*=\s*([a-z0-9_,\s-]+?)"
    r"(?:\s*--.*)?$")


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str            # repo-root-relative, posix separators
    line: int
    col: int
    message: str
    suppressed: bool = False

    def format(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] " \
               f"{self.message}{tag}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}


class FileContext:
    """One parsed source file plus its suppression tables."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.line_suppressions: Dict[int, Set[str]] = {}
        self.file_suppressions: Set[str] = set()
        self._scan_comments()

    def _scan_comments(self) -> None:
        try:
            toks = tokenize.generate_tokens(io.StringIO(self.source).readline)
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _SUPPRESS_RE.search(tok.string)
                if not m:
                    continue
                rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
                if m.group(1) == "disable-file":
                    self.file_suppressions |= rules
                else:
                    self.line_suppressions.setdefault(
                        tok.start[0], set()).update(rules)
        except tokenize.TokenError:
            pass  # ast.parse already succeeded; comments best-effort

    def is_suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_suppressions:
            return True
        return rule in self.line_suppressions.get(line, set())


class Rule:
    """One invariant. Subclasses set `id`/`description` and implement
    `check(ctx)`; cross-file rules may also implement `finalize(ctxs)`,
    called once after every file has been visited.  `language` routes
    dispatch: "py" rules see FileContext (Python AST), "c" rules see
    clex.CFileContext (token/function repr of native/*.c)."""

    id: str = ""
    description: str = ""
    language: str = "py"

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        return iter(())

    def finalize(self, ctxs: List[FileContext]) -> Iterator[Violation]:
        return iter(())


@dataclass
class LintReport:
    violations: List[Violation] = field(default_factory=list)
    suppressed: List[Violation] = field(default_factory=list)
    files_scanned: int = 0
    parse_errors: List[str] = field(default_factory=list)

    def counts_by_rule(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for v in self.violations:
            out[v.rule] = out.get(v.rule, 0) + 1
        return out

    def suppression_counts(self) -> Dict[str, int]:
        """``"<path>:<rule>" -> count`` for the baseline ratchet."""
        out: Dict[str, int] = {}
        for v in self.suppressed:
            k = f"{v.path}:{v.rule}"
            out[k] = out.get(k, 0) + 1
        return out

    def to_dict(self) -> dict:
        return {
            "files_scanned": self.files_scanned,
            "counts": self.counts_by_rule(),
            "violations": [v.to_dict() for v in self.violations],
            "suppressed": [v.to_dict() for v in self.suppressed],
            "parse_errors": self.parse_errors,
        }


_SOURCE_EXTS = (".py", ".c")


def iter_source_files(paths: Iterable[str],
                      exts: Tuple[str, ...] = _SOURCE_EXTS) -> Iterator[str]:
    skip_dirs = {"__pycache__", ".git", "build", "node_modules"}
    seen: Set[str] = set()  # overlapping args must not lint a file twice

    def emit(path: str) -> Iterator[str]:
        ap = os.path.abspath(path)
        if ap not in seen:
            seen.add(ap)
            yield path

    for p in paths:
        if os.path.isfile(p):
            if p.endswith(exts):
                yield from emit(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames if d not in skip_dirs)
            for fn in sorted(filenames):
                if fn.endswith(exts):
                    yield from emit(os.path.join(dirpath, fn))




def run_paths(paths: Iterable[str], rules: Iterable[Rule],
              root: Optional[str] = None) -> LintReport:
    """Lint every .py under `paths`. Relative paths in the report are
    computed against `root` (default: cwd) — rule scoping (allowed files,
    raw-path seams) keys off these relpaths."""
    from .clex import CFileContext
    root = os.path.abspath(root or os.getcwd())
    rules = list(rules)
    report = LintReport()
    ctxs: List[FileContext] = []
    for path in iter_source_files(paths):
        ap = os.path.abspath(path)
        rel = os.path.relpath(ap, root)
        try:
            with open(ap, "r", encoding="utf-8") as f:
                src = f.read()
            if ap.endswith(".c"):
                ctx = CFileContext(ap, rel, src)
            else:
                ctx = FileContext(ap, rel, src)
        except (SyntaxError, ValueError, UnicodeDecodeError, OSError) as e:
            # ValueError: ast.parse rejects NUL bytes with it (< 3.12);
            # CParseError (brace-unbalanced C) IS-A ValueError
            report.parse_errors.append(f"{rel}: {e}")
            continue
        ctxs.append(ctx)
        report.files_scanned += 1
        lang = getattr(ctx, "language", "py")
        for rule in rules:
            if rule.language != lang:
                continue
            for v in rule.check(ctx):
                _file_violation(report, ctx, v)
    by_rel = {c.relpath: c for c in ctxs}
    for rule in rules:
        lang_ctxs = [c for c in ctxs
                     if getattr(c, "language", "py") == rule.language]
        for v in rule.finalize(lang_ctxs):
            ctx = by_rel.get(v.path)
            if ctx is not None:
                _file_violation(report, ctx, v)
            else:
                report.violations.append(v)
    report.violations.sort(key=lambda v: (v.path, v.line, v.rule))
    report.suppressed.sort(key=lambda v: (v.path, v.line, v.rule))
    return report


def _file_violation(report: LintReport, ctx: FileContext,
                    v: Violation) -> None:
    if ctx.is_suppressed(v.rule, v.line):
        report.suppressed.append(Violation(
            v.rule, v.path, v.line, v.col, v.message, suppressed=True))
    else:
        report.violations.append(v)


# ---------------------------------------------------------------------------
# Baseline ratchet
# ---------------------------------------------------------------------------

def load_baseline(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def write_baseline(path: str, report: LintReport) -> None:
    doc = {
        "version": 1,
        "comment": "corelint suppression ratchet — regenerate with "
                   "`python -m stellar_core_tpu_torch.lint --write-baseline`",
        "suppressions": report.suppression_counts(),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def check_baseline(report: LintReport,
                   baseline: dict) -> List[str]:
    """Ratchet check: fail messages when the suppression set drifts from
    the committed baseline in EITHER direction.  Growth means a new,
    unreviewed suppression; shrinkage means the baseline is stale and
    must be regenerated — otherwise the removed entry's headroom would
    let a later unreviewed suppression in the same file slip through."""
    allowed: Dict[str, int] = baseline.get("suppressions", {})
    current = report.suppression_counts()
    problems: List[str] = []
    for key in sorted(set(current) | set(allowed)):
        n, cap = current.get(key, 0), allowed.get(key, 0)
        if n > cap:
            problems.append(
                f"suppression ratchet: {key} has {n} suppressed finding(s), "
                f"baseline allows {cap} — justify and regenerate the "
                f"baseline if intentional")
        elif n < cap:
            problems.append(
                f"suppression ratchet: {key} has {n} suppressed finding(s) "
                f"but the baseline still lists {cap} — ratchet down by "
                f"regenerating the baseline (--write-baseline)")
    return problems


# ---------------------------------------------------------------------------
# Reporters
# ---------------------------------------------------------------------------

def render_human(report: LintReport, verbose_suppressed: bool = False) -> str:
    lines: List[str] = []
    for v in report.violations:
        lines.append(v.format())
    if verbose_suppressed:
        for v in report.suppressed:
            lines.append(v.format())
    counts = report.counts_by_rule()
    summary = ", ".join(f"{r}={n}" for r, n in sorted(counts.items())) \
        or "clean"
    lines.append(
        f"corelint: {report.files_scanned} files, "
        f"{len(report.violations)} violation(s) [{summary}], "
        f"{len(report.suppressed)} suppressed")
    for e in report.parse_errors:
        lines.append(f"parse error: {e}")
    return "\n".join(lines)


def render_json(report: LintReport) -> str:
    return json.dumps(report.to_dict(), indent=2, sort_keys=True)


# ---------------------------------------------------------------------------
# Shared helpers used by several rules
# ---------------------------------------------------------------------------

def path_is(relpath: str, suffix: str) -> bool:
    """Path-segment-aware suffix match, robust to a --root above the repo
    root (relpaths then carry extra leading segments) without matching
    mere filename collisions ('workbench.py' is not 'bench.py')."""
    return relpath == suffix or relpath.endswith("/" + suffix)


def dotted_name(node: ast.AST) -> Optional[str]:
    """`a.b.c` Attribute/Name chain as a dotted string, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: ast.Module) -> Dict[str, str]:
    """Map local name -> canonical dotted origin for every import in the
    module (`import time as _t` -> {"_t": "time"}; `from datetime import
    datetime as dt` -> {"dt": "datetime.datetime"})."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out
