"""clock-discipline: VirtualClock is the only time source.

The determinism backbone (util/clock.py) requires that wall-clock reads
never leak into subsystem code: `time.time()`, `time.monotonic()` and
`datetime.now()/utcnow()/today()` are forbidden everywhere except the
clock itself, the perf/timing surface, and the chip driver
(chip_smoke.py, which times the card's runs).  Everything
else must go through VirtualClock (simulated time) or the blessed
real-time helpers `util.clock.monotonic_now()` / `wall_now()`.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import (FileContext, Rule, Violation, dotted_name,
                    import_aliases, path_is)

FORBIDDEN = {
    "time.time",
    "time.time_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
    "datetime.datetime.today",
    "datetime.date.today",
}

ALLOWED_FILES = (
    "stellar_core_tpu_torch/util/clock.py",
    "stellar_core_tpu_torch/util/perf.py",
    "chip_smoke.py",
)


class ClockDisciplineRule(Rule):
    id = "clock-discipline"
    description = ("wall-clock reads (time.time/time.monotonic/"
                   "datetime.now) outside util/clock.py, util/perf.py "
                   "and chip_smoke.py")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if any(path_is(ctx.relpath, a) for a in ALLOWED_FILES):
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
            if resolved in FORBIDDEN:
                yield Violation(
                    self.id, ctx.relpath, node.lineno, node.col_offset,
                    f"{resolved}() bypasses VirtualClock — use the clock "
                    f"(or util.clock.monotonic_now/wall_now for infra "
                    f"timing)")
