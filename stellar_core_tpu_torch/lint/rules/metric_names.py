"""metric-registry: every statically-visible metric name is canonical.

The runtime lint (tests/test_observability.py) only sees names a
simulated close happens to record; this rule checks every string literal
handed to `registry().timer/meter/gauge/counter/histogram/weak_gauge`,
`perf.scoped_timer` and `tracing.timed_span` across the whole tree at
parse time: it must match ``layer.subsystem.event`` (METRIC_NAME_RE) and
appear in CANONICAL_METRICS — or, for data-dependent families built
with f-strings, start with a CANONICAL_PREFIXES entry.  Dynamic names
(variables) are skipped; keep those funnels few.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from ..core import FileContext, Rule, Violation, path_is

REGISTRY_METHODS = ("counter", "meter", "timer", "gauge", "histogram",
                    "weak_gauge")
FREE_FUNCS = ("scoped_timer", "timed_span")

# the metric surface itself and the perf shim pass caller-supplied names
EXEMPT_FILES = (
    "stellar_core_tpu_torch/util/metrics.py",
    "stellar_core_tpu_torch/util/perf.py",
)


def _canonical_tables():
    from ...util.metrics import (CANONICAL_METRICS, CANONICAL_PREFIXES,
                                 METRIC_NAME_RE)
    return CANONICAL_METRICS, CANONICAL_PREFIXES, METRIC_NAME_RE


def _metric_name_arg(node: ast.Call) -> Optional[ast.expr]:
    f = node.func
    named = (isinstance(f, ast.Attribute) and f.attr in REGISTRY_METHODS) \
        or (isinstance(f, ast.Name) and f.id in FREE_FUNCS) \
        or (isinstance(f, ast.Attribute) and f.attr in FREE_FUNCS)
    if not named:
        return None
    if node.args:
        return node.args[0]
    for kw in node.keywords:  # registry().timer(name="...") counts too
        if kw.arg == "name":
            return kw.value
    return None


class MetricRegistryRule(Rule):
    id = "metric-registry"
    description = ("string literals passed to metric constructors must "
                   "match layer.subsystem.event and the canonical list "
                   "in util/metrics.py")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if any(path_is(ctx.relpath, e) for e in EXEMPT_FILES):
            return
        canon, prefixes, name_re = _canonical_tables()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            arg = _metric_name_arg(node)
            if arg is None:
                continue
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                name = arg.value
                if not name_re.match(name):
                    yield Violation(
                        self.id, ctx.relpath, arg.lineno, arg.col_offset,
                        f"metric name {name!r} does not match "
                        f"layer.subsystem.event")
                elif name not in canon \
                        and not name.startswith(tuple(prefixes)):
                    yield Violation(
                        self.id, ctx.relpath, arg.lineno, arg.col_offset,
                        f"metric name {name!r} is not in CANONICAL_METRICS "
                        f"(util/metrics.py) — document it there and in "
                        f"README §Observability")
            elif isinstance(arg, ast.JoinedStr):
                # f-string family: the literal head must pin a canonical
                # prefix so the data-dependent tail stays namespaced
                head = ""
                if arg.values and isinstance(arg.values[0], ast.Constant):
                    head = str(arg.values[0].value)
                if not head.startswith(tuple(prefixes)):
                    yield Violation(
                        self.id, ctx.relpath, arg.lineno, arg.col_offset,
                        f"f-string metric name (head {head!r}) must start "
                        f"with a CANONICAL_PREFIXES entry")
