"""decode-free-seam: the raw-record path never rehydrates entries.

The streaming merge pipeline guarantees O(1) merge memory by moving
packed XDR records file-to-file without ever constructing a BucketEntry.
That guarantee was enforced by a runtime monkeypatch test (forbidden
rehydrate); this rule makes it a compile-time property: inside the
raw-path scopes —

  * ``merge_buckets_raw`` in bucket/bucket.py,
  * class ``BucketStreamWriter`` in bucket/manager.py,
  * the whole native bridge module ledger/native_apply.py,

— any ``.entries`` attribute access (the lazy-rehydrate property) or any
reference to ``BucketEntry`` (constructing or re-tagging via the decoded
type) is a violation.  Re-tagging must stay a 4-byte wire splice.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

from ..core import FileContext, Rule, Violation, path_is

# (relpath suffix, scope qualname or None for whole module)
RAW_PATH_SCOPES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("stellar_core_tpu_torch/bucket/bucket.py", "merge_buckets_raw"),
    ("stellar_core_tpu_torch/bucket/manager.py", "BucketStreamWriter"),
    ("stellar_core_tpu_torch/ledger/native_apply.py", None),
)

FORBIDDEN_ATTRS = ("entries", "_rehydrate", "packed_entries")
FORBIDDEN_NAME = "BucketEntry"


class DecodeFreeSeamRule(Rule):
    id = "decode-free-seam"
    description = ("raw-record scopes (merge_buckets_raw, "
                   "BucketStreamWriter, the native bridge) must not "
                   "touch Bucket.entries or BucketEntry")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        for suffix, scope in RAW_PATH_SCOPES:
            if not path_is(ctx.relpath, suffix):
                continue
            for node in self._scope_nodes(ctx.tree, scope):
                yield from self._scan(ctx, node, scope)

    @staticmethod
    def _scope_nodes(tree: ast.Module, scope: Optional[str]) -> List[ast.AST]:
        if scope is None:
            return [tree]
        out: List[ast.AST] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) and node.name == scope:
                out.append(node)
        return out

    def _scan(self, ctx: FileContext, scope_node: ast.AST,
              scope: Optional[str]) -> Iterator[Violation]:
        where = scope or "module"
        for node in ast.walk(scope_node):
            if isinstance(node, ast.Attribute) \
                    and node.attr in FORBIDDEN_ATTRS:
                yield Violation(
                    self.id, ctx.relpath, node.lineno, node.col_offset,
                    f".{node.attr} rehydrates decoded entries inside the "
                    f"raw path ({where}) — stream packed records instead")
            elif isinstance(node, ast.Name) and node.id == FORBIDDEN_NAME:
                yield Violation(
                    self.id, ctx.relpath, node.lineno, node.col_offset,
                    f"{FORBIDDEN_NAME} referenced inside the raw path "
                    f"({where}) — records must stay packed; re-tag via "
                    f"a 4-byte splice")
