"""exception-hygiene: no silently swallowed broad exception handlers.

`except Exception` (or bare `except:`) is allowed only when the handler
visibly deals with the failure: it re-raises, logs, or routes the error
into an explicit failure path (`self._fail(...)`, `peer.drop(...)`).
Anything else — `pass`, bare `return None`, `continue` — swallows bugs
on hot paths (ledger close, overlay receive) and must either narrow the
exception type or carry an explicit suppression with a reason:

    except Exception:  # corelint: disable=exception-hygiene -- why
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import FileContext, Rule, Violation

BROAD_TYPES = ("Exception", "BaseException")
LOG_METHODS = ("debug", "info", "warning", "error", "exception", "critical")
# failure-path sinks: methods that by convention log/record and propagate
# the failure (Work._fail fails the work machine, Peer.drop logs + closes)
FAILURE_SINKS = ("_fail", "fail", "drop")


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except:
    if isinstance(t, ast.Name):
        return t.id in BROAD_TYPES
    if isinstance(t, ast.Tuple):
        return any(isinstance(e, ast.Name) and e.id in BROAD_TYPES
                   for e in t.elts)
    return False


def _handles(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and \
                    (f.attr in LOG_METHODS or f.attr in FAILURE_SINKS):
                return True
            if isinstance(f, ast.Name) and f.id in FAILURE_SINKS:
                return True
    return False


class ExceptionHygieneRule(Rule):
    id = "exception-hygiene"
    description = ("broad `except Exception` handlers must re-raise, "
                   "log, route to a failure path, or carry an explicit "
                   "suppression")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if _is_broad(node) and not _handles(node):
                yield Violation(
                    self.id, ctx.relpath, node.lineno, node.col_offset,
                    "broad exception handler swallows errors silently — "
                    "narrow the type, log/re-raise, or suppress with a "
                    "reason")
