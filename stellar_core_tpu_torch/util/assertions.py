"""Always-on assertions (reference: src/util/GlobalChecks.h —
releaseAssert / releaseAssertOrThrow).

The reference never uses plain `assert` for consensus-critical conditions:
release builds keep the checks (crash-only/fail-stop philosophy, SURVEY.md
§5.2-5.3).  Python's `assert` disappears under ``-O`` — these don't.
Plain `assert` statements remain the marker for strippable hot-loop
sanity checks.
"""

from __future__ import annotations


class ReleaseAssertError(AssertionError):
    """An always-on invariant failed — the process state is suspect
    (callers are expected NOT to catch this; fail-stop)."""


def release_assert(cond: bool, msg: str = "release assertion failed") -> None:
    """Fail-stop check that survives ``python -O`` (reference:
    releaseAssert)."""
    if not cond:
        raise ReleaseAssertError(msg)


def release_assert_or_throw(cond: bool, exc_type=None,
                            msg: str = "invariant violated") -> None:
    """Like release_assert but raising a caller-chosen exception type
    (reference: releaseAssertOrThrow)."""
    if not cond:
        raise (exc_type or ReleaseAssertError)(msg)

# For strippable hot-loop sanity checks, use a plain `assert` statement at
# the call site — a helper function cannot avoid evaluating the condition.
