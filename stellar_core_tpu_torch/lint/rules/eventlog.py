"""eventlog-partitions: flight-event partition literals are real log
partitions.

``eventlog.record(partition, severity, msg, **fields)`` validates its
partition at runtime against ``util/logging.PARTITIONS`` — but a typo'd
literal then only explodes when that (possibly rare) lifecycle edge
actually fires, which for fail-stop paths is exactly the moment the
flight recorder must not break.  This rule moves the check to parse
time: every string literal passed as the first argument of an
``eventlog.record(...)`` call (or a bare ``record(...)`` imported from
util.eventlog) must be a member of PARTITIONS.  Dynamic partitions
(variables) are skipped — the runtime check covers those funnels.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import FileContext, Rule, Violation, path_is

# the recorder itself passes caller-supplied names through
EXEMPT_FILES = ("stellar_core_tpu_torch/util/eventlog.py",)


def _partitions():
    from ...util.logging import PARTITIONS
    return frozenset(PARTITIONS)


def _imports_record_from_eventlog(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.endswith("eventlog"):
            if any(a.name == "record" for a in node.names):
                return True
    return False


class EventlogPartitionRule(Rule):
    id = "eventlog-partitions"
    description = ("string literals passed as the partition of "
                   "eventlog.record() must be members of "
                   "util/logging.PARTITIONS")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if any(path_is(ctx.relpath, e) for e in EXEMPT_FILES):
            return
        partitions = _partitions()
        bare_record = _imports_record_from_eventlog(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            f = node.func
            named = (isinstance(f, ast.Attribute) and f.attr == "record"
                     and isinstance(f.value, ast.Name)
                     and f.value.id == "eventlog") \
                or (bare_record and isinstance(f, ast.Name)
                    and f.id == "record")
            if not named:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                if arg.value not in partitions:
                    yield Violation(
                        self.id, ctx.relpath, arg.lineno, arg.col_offset,
                        f"eventlog partition {arg.value!r} is not in "
                        f"util/logging.PARTITIONS")
