"""Carry the JAX package's device state into the port.

The JAX side's arrays come in as numpy (``np.asarray`` of a jax array).
Field elements are 16-limb int64, partially reduced; the port keeps device
state as canonical 32-byte encodings on every device (the generic path's
key rows, the resident key tables, the base table), so ``canonical_bytes``
is the whole conversion.  Quorum bitmasks are uint32 words; the port holds
them as int64 words with 32 bits used (``words_from_jax``).
"""

from __future__ import annotations

import numpy as np
import torch

from .accel import field
from .accel.tables import KeyTableCache


def canonical_bytes(limbs: np.ndarray) -> np.ndarray:
    """(..., 16) int64 limbs -> (..., 32) uint8 canonical encodings."""
    return field.to_bytes(torch.from_numpy(np.array(limbs, dtype=np.int64))).numpy()


def key_rows_from_jax(ucx, ucy, uct) -> np.ndarray:
    """The generic path's (nk, 16) x3 key limb rows -> the (nk, 3, 32)
    uint8 key rows that ``ed25519.verify_generic`` takes."""
    return np.stack([canonical_bytes(ucx), canonical_bytes(ucy),
                     canonical_bytes(uct)], axis=1)


def key_table_from_jax(np_table: np.ndarray, slot_of: dict, *,
                       device) -> KeyTableCache:
    """A port KeyTableCache holding a JAX-built ``KeyTableCache.table``
    (slots, 64, 16, 4, 16) and its pk -> slot map.  A ``build_tables``
    output or the base table converts the same way: ``canonical_bytes``."""
    cache = KeyTableCache(np_table.shape[0], device=device)
    cache.table = torch.from_numpy(canonical_bytes(np_table)).to(cache.device)
    cache.slot_of = dict(slot_of)
    return cache


def words_from_jax(words: np.ndarray, device="cpu") -> torch.Tensor:
    """uint32 bitmask words (any shape) -> the port's int64 words."""
    return torch.from_numpy(np.asarray(words).astype(np.int64)).to(device)


def quorum_state_from_jax(checker, frontier: np.ndarray, device="cpu"):
    """A reference TPUQuorumIntersectionChecker's map tables and a [B, W]
    uint32 frontier -> (frontier, top_thr, top_masks, inner_thr,
    inner_masks) as the port's quorum functions take them."""
    thr = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32)).to(device)
    return (words_from_jax(frontier, device), thr(checker.top_thr),
            words_from_jax(checker.top_masks, device), thr(checker.inner_thr),
            words_from_jax(checker.inner_masks, device))
