"""FutureBucket: a level's pending merge.

Reference: src/bucket/FutureBucket.{h,cpp}.  The reference runs level
merges on worker threads and resolves them at the next spill boundary;
merges are pure functions of their inputs, so this one merges at once.
The HAS serializes a level's pending merge as ``next``:
``{"state": 1, "output": <hex>}`` once resolved (FB_HASH_OUTPUT).
"""

from __future__ import annotations

from .bucket import Bucket, merge_buckets


class FutureBucket:
    __slots__ = ("_output",)

    def __init__(self, curr: Bucket, snap: Bucket, keep_tombstones: bool,
                 protocol_version: int):
        self._output = merge_buckets(curr, snap, keep_tombstones,
                                     protocol_version)

    @staticmethod
    def from_output(bucket: Bucket) -> "FutureBucket":
        """A future from its serialized output (HAS state 1)."""
        fb = FutureBucket.__new__(FutureBucket)
        fb._output = bucket
        return fb

    def resolve(self) -> Bucket:
        return self._output

    def serialize(self) -> dict:
        """The HAS `next` form (reference: FutureBucket::save)."""
        return {"state": 1, "output": self._output.hash().hex()}
