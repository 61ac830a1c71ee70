"""Quorum-intersection enumerator on CUDA: the port of accel/quorum.py.

Counterpart of stellar_core_tpu/accel/quorum.py (the TPU enumerator of
stellar-core's QuorumIntersectionChecker::networkEnumerateAndCheck
MinQuorums).  The search is the reference's: node subsets are bitmasks of
W 32-bit words, the branch-and-bound DFS is a depth-synchronised frontier
BFS over one global variable order (in-degree, descending), so every
frontier row at a depth shares the remaining-mask, and a frontier row that
is a quorum whose scc-complement holds a quorum is a split witness, which
the exact CPU oracle (herder/quorum_intersection.py) re-checks before any
verdict leaves the class.

Words are int64 tensors with 32 bits used: torch's uint32 lacks ``~``,
``>>`` and a popcount on the CPU.  Bit n of word n // 32 is node n.

Two kernels (csrc/quorum.cu), each beside its plain version here:

- **K-QF** (``flags_kernel``) replaces ``_prune_step`` / ``_child_flags``
  (stellar_core_tpu/accel/quorum.py:121-178): the alive / is-quorum /
  witness flags of each child row, one thread per row, the contraction
  fixpoint a loop of the thread's own.  ``prune_step`` launches it on a
  batch of children; each depth of ``segment_step`` launches it on the
  frontier itself, child t < n being fr[t] and child n + t being
  fr[t] | bit.
- **K-QC** (``compact_kernel``) replaces the rest of a ``_segment_step``
  depth (:236-263): the stable compaction of the alive children (exclude
  branch first, then include branch, each in index order, as
  ``argsort(~alive)`` orders them), the first WITNESS_CAP witness rows in
  the same order, the per-depth counts and the freeze on overflow.

A segment runs its SEG_DEPTHS depths back to back on the current stream;
the live count, the overflow depth and the 10-int meta stay on the card,
and the host syncs once per segment, on the meta.

With several devices the checker takes the reference's mesh path
(quorum.py:318-338, 464-494): every depth host-chunked, each prune_step
chunk split into contiguous parts, one a device, with the map and K-QF's
tables on each device, and the flags gathered in order.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _cuda_build
from ..device import Shards, parts, resolve, resolve_all, upload
from ..herder.quorum_intersection import (
    InterruptedError_, QuorumIntersectionChecker, QuorumIntersectionResult,
    flatten_qmap, tarjan_sccs)

# Padding sentinel for inner-set thresholds: never satisfiable.
_PAD_THR = 1 << 30
# K-QF is instantiated for W = 1..MAX_WORDS words a row.
MAX_WORDS = 8
MAX_NODES = 32 * MAX_WORDS
# Depths fused per segment, and the per-depth capacity of the witness rows
# (the reference's values: the same map takes the same path).
SEG_DEPTHS = 4
WITNESS_CAP = 8
# children a K-QC tile holds (csrc/quorum.cu: 256 threads x 8)
QC_TILE = 2048
# K-QF's block size and the shared memory a block may opt in to on sm_90
# (csrc/quorum.cu: QF_THREADS, MAX_SMEM)
QF_THREADS = 128
FLAGS_SMEM_MAX = 232448


def _masks_to_words(masks, n_words: int) -> np.ndarray:
    out = np.zeros((len(masks), n_words), dtype=np.int64)
    for i, m in enumerate(masks):
        for w in range(n_words):
            out[i, w] = (m >> (32 * w)) & 0xFFFFFFFF
    return out


def _words_to_mask(words) -> int:
    m = 0
    for w in range(words.shape[-1]):
        m |= int(words[w]) << (32 * w)
    return m


# -- plain versions ----------------------------------------------------------

# None, or a dict of two counts that the plain versions add to, on the
# rows K-QF's per-row loops would run: "distinct", the popcounts a slice
# pass needs, (distinct top masks + distinct satisfiable inner pairs) W for
# each non-empty row at each fixpoint pass (the pass that finds no change
# included) and in the is-quorum pass; "per_member", what a design that
# evaluates each member's whole qset would issue, (1 + K) W for each member
# of the set at each such pass.  chip_smoke.py sets it to count the work
# of K-QF's bound.
popcount_tally = None


def _tally(distinct, per_member) -> None:
    if popcount_tally is not None:
        popcount_tally["distinct"] += int(distinct)
        popcount_tally["per_member"] += int(per_member)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each word (int64 holding 32 bits), SWAR."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def satisfied(S, top_thr, top_masks, inner_thr, inner_masks):
    """For each subset and node: does S contain a slice of the node's qset?

    S [B, W]; top_thr [N]; top_masks [N, W]; inner_thr [N, K];
    inner_masks [N, K, W].  Returns [B, N] bool.  Each distinct top mask
    and each distinct inner (mask, threshold) pair is evaluated once (an
    org's inner set recurs in every node's qset); a [P, N] matrix of pair
    uses sums the satisfied inner sets of each node.
    """
    sets, top_of, pair_thr, uses = _distinct_sets(top_masks, inner_thr,
                                                  inner_masks)
    counts = popcount(S[:, None, :] & sets[None]).sum(-1)
    n_tops = len(sets) - len(pair_thr)
    ok = counts[:, n_tops:] >= pair_thr[None]
    # small integers: exact in float32 (and in TF32)
    hits = counts[:, top_of] + (ok.to(torch.float32) @ uses).to(torch.int64)
    return hits >= top_thr[None, :]


# satisfied's last map: (its tensors, their versions, _distinct_sets of it)
_last_sets = None


def _distinct_sets(top_masks, inner_thr, inner_masks):
    """(the distinct top masks, then the distinct inner masks [T + P, W],
    each node's index into the top masks [N], the inner masks' thresholds
    [P], pair uses [P, N] float32) of a map.  The checker passes the same map tensors at every
    depth and chunk, so the last map's sets are kept (the tensors held, so
    their identity stands, and their versions compared, so an in-place
    write is seen)."""
    global _last_sets
    key = (top_masks, inner_thr, inner_masks)
    versions = tuple(t._version for t in key)
    last = _last_sets
    if last is not None and all(a is b for a, b in zip(last[0], key)) \
            and last[1] == versions:
        return last[2]
    n, k, n_words = inner_masks.shape
    tops, top_of = torch.unique(top_masks, dim=0, return_inverse=True)
    pairs = torch.cat([inner_masks.reshape(n * k, n_words),
                       inner_thr.reshape(n * k, 1).to(torch.int64)], 1)
    pairs, pair_of = torch.unique(pairs, dim=0, return_inverse=True)
    uses = torch.zeros((len(pairs), n), dtype=torch.float32,
                       device=top_masks.device)
    node = torch.arange(n, device=top_masks.device).repeat_interleave(k)
    uses.index_put_((pair_of, node), torch.ones_like(node, dtype=torch.float32),
                    accumulate=True)
    sets = (torch.cat([tops, pairs[:, :n_words]]), top_of, pairs[:, n_words],
            uses)
    _last_sets = (key, versions, sets)
    return sets


def pack_bits(sat: torch.Tensor, n_words: int) -> torch.Tensor:
    """[B, N] bool -> [B, W] words (bit n of word n // 32 = sat[:, n])."""
    b, n = sat.shape
    bits = torch.zeros((b, n_words * 32), dtype=torch.int64, device=sat.device)
    bits[:, :n] = sat
    shifts = torch.arange(32, dtype=torch.int64, device=sat.device)
    return (bits.reshape(b, n_words, 32) << shifts).sum(-1)


def _pass_popcounts(S, top_masks, inner_thr, inner_masks):
    """([B] popcounts of a slice pass over each row of S with the distinct
    sets, [B] with each member's qset): the two counts of popcount_tally."""
    n, k, n_words = inner_masks.shape
    real = inner_thr.reshape(-1) <= 32 * n_words     # not padding
    pairs = torch.cat([inner_masks.reshape(n * k, n_words),
                       inner_thr.reshape(n * k, 1).to(torch.int64)], 1)[real]
    sets = len(torch.unique(top_masks, dim=0)) + (
        len(torch.unique(pairs, dim=0)) if len(pairs) else 0)
    return (S.any(-1).to(torch.int64) * sets * n_words,
            popcount(S).sum(-1) * (1 + k) * n_words)


def contract_fixpoint(S, top_thr, top_masks, inner_thr, inner_masks):
    """Greatest quorum inside each subset (0 if none): repeat
    S <- S & pack(satisfied(S)) until no row changes."""
    active = None
    while True:
        S2 = S & pack_bits(satisfied(S, top_thr, top_masks, inner_thr,
                                     inner_masks), S.shape[1])
        changed = (S2 != S).any(-1)
        if popcount_tally is not None:
            # a row's own loop runs until its pass finds no change
            costs = _pass_popcounts(S, top_masks, inner_thr, inner_masks)
            _tally(*(c.sum() if active is None else c[active].sum()
                     for c in costs))
            active = changed
        if not bool(changed.any()):
            return S
        S = S2


def child_flags(children, remaining, scc_words, top_thr, top_masks,
                inner_thr, inner_masks):
    """(dead [B], is_q [B], witness [B]) of candidate committed-masks
    `children` against the depth's remaining-mask; witness = is_q and the
    scc-complement of the child contains a quorum (a proven split).  The
    reference's _child_flags (quorum.py:121-160)."""
    perimeter = children | remaining[None, :]
    mq = contract_fixpoint(perimeter, top_thr, top_masks, inner_thr,
                           inner_masks)
    dead = (children & ~mq).any(-1) | ~mq.any(-1)
    sat = pack_bits(satisfied(children, top_thr, top_masks, inner_thr,
                              inner_masks), children.shape[1])
    if popcount_tally is not None:
        _tally(*(c.sum() for c in _pass_popcounts(children, top_masks,
                                                   inner_thr, inner_masks)))
    is_q = children.any(-1) & ~(children & ~sat).any(-1)
    comp = torch.where(is_q[:, None], scc_words[None, :] & ~children, 0)
    comp_mq = contract_fixpoint(comp, top_thr, top_masks, inner_thr,
                                inner_masks)
    return dead, is_q, is_q & comp_mq.any(-1)


def prune_step_plain(children, remaining, scc_words, top_thr, top_masks,
                     inner_thr, inner_masks):
    """One depth, batched: (alive = survives pruning and is not itself a
    quorum, is_quorum, witness), each [B] bool."""
    dead, is_q, wit = child_flags(children, remaining, scc_words, top_thr,
                                  top_masks, inner_thr, inner_masks)
    return ~dead & ~is_q, is_q, wit


def compact_plain(children, alive, is_q, wit):
    """The stable compaction of one depth: (alive rows in order, quorum
    hits, witness count, the first WITNESS_CAP witness rows, zero-padded)."""
    rows = torch.zeros((WITNESS_CAP, children.shape[1]), dtype=torch.int64,
                       device=children.device)
    first = children[wit][:WITNESS_CAP]
    rows[:len(first)] = first
    return children[alive], int(is_q.sum()), int(wit.sum()), rows


def segment_step_plain(frontier, count, bits_seq, rems_seq, active_seq,
                       scc_words, top_thr, top_masks, inner_thr,
                       inner_masks):
    """SEG_DEPTHS frontier depths: the reference's _segment_step
    (quorum.py:195-271).  frontier [C, W] (rows >= count are padding);
    returns (frontier', meta [2 SEG_DEPTHS + 2] int32 = per-depth quorum
    hits ++ per-depth witnesses ++ [count', overflow depth or -1],
    w_rows [SEG_DEPTHS, WITNESS_CAP, W]).  A depth whose alive children
    exceed C leaves the state as it was (its counts 0) and ends the
    segment.  Only frontier'[:count'] and w_rows[j, :witnesses_j] mean
    anything."""
    capacity, n_words = frontier.shape
    fr, cnt, ovf = frontier, int(count), -1
    meta = [0] * (2 * SEG_DEPTHS) + [0, -1]
    w_rows = torch.zeros((SEG_DEPTHS, WITNESS_CAP, n_words),
                         dtype=torch.int64, device=frontier.device)
    for d in range(SEG_DEPTHS):
        if not bool(active_seq[d]) or ovf >= 0:
            continue
        live = fr[:cnt]
        children = torch.cat([live, live | bits_seq[d][None, :]])
        dead, is_q, wit = child_flags(children, rems_seq[d], scc_words,
                                      top_thr, top_masks, inner_thr,
                                      inner_masks)
        kept, q, w, rows = compact_plain(children, ~dead & ~is_q, is_q, wit)
        if len(kept) > capacity:
            ovf = d
            continue
        fr = torch.zeros_like(frontier)
        fr[:len(kept)] = kept
        cnt = len(kept)
        meta[d], meta[SEG_DEPTHS + d] = q, w
        w_rows[d] = rows
    meta[2 * SEG_DEPTHS:] = [cnt, ovf]
    return (fr, torch.tensor(meta, dtype=torch.int32, device=frontier.device),
            w_rows)


# -- K-QF's form of the map ---------------------------------------------------

class FlagTables(NamedTuple):
    """A map as K-QF reads it (csrc/quorum.cuh's QMap): each distinct top
    mask and each distinct satisfiable inner (mask, threshold) pair once,
    and per node its top threshold, the index of its top mask and its
    pairs as a bitmask.  A pair a node's qset holds twice is two pairs."""
    top_thr: torch.Tensor      # [N] int32
    top_of: torch.Tensor       # [N] int32
    tops: torch.Tensor         # [T, W] int64 words
    pair_thr: torch.Tensor     # [P] int32
    pairs: torch.Tensor        # [P, W] int64 words
    node_pairs: torch.Tensor   # [N, ceil(P / 32)] int64 words


def flag_tables(top_thr, top_masks, inner_thr, inner_masks) -> FlagTables:
    """K-QF's tables of a map given as flatten_qmap's padded tensors, on
    their device.  Inner pairs above 32 W (the padding) are never
    satisfied and are left out."""
    tm, it, im = (_host(a) for a in (top_masks, inner_thr, inner_masks))
    n, k, n_words = im.shape
    tops, top_of = np.unique(tm, axis=0, return_inverse=True)
    index, pair_thr, pairs, node_bits = {}, [], [], []
    for i in range(n):
        mine, bits = {}, 0
        for j in range(k):
            thr = int(it[i, j])
            if thr > 32 * n_words:
                continue
            key = (thr, im[i, j].tobytes())
            mine[key] = mine.get(key, -1) + 1     # its occurrence in the node
            p = index.setdefault(key + (mine[key],), len(index))
            if p == len(pairs):
                pair_thr.append(thr)
                pairs.append(im[i, j])
            bits |= 1 << p
        node_bits.append(bits)
    dev = top_masks.device
    return FlagTables(
        top_thr.to(torch.int32), upload(top_of.reshape(-1).astype(np.int32), dev),
        upload(tops.astype(np.int64), dev),
        upload(np.array(pair_thr, dtype=np.int32), dev),
        upload(np.array(pairs, dtype=np.int64).reshape(-1, n_words), dev),
        upload(_masks_to_words(node_bits, -(-len(pairs) // 32)), dev))


def flags_smem_bytes(tables: FlagTables) -> int:
    """Shared memory K-QF takes for `tables` (csrc/quorum.cuh's
    q_flags_smem): the tables as 32-bit words and each thread's scratch."""
    n, pair_words = tables.node_pairs.shape
    n_tops, n_words = tables.tops.shape
    n_pairs = tables.pairs.shape[0]
    return (4 * (2 * n + n * pair_words + n_pairs + (n_tops + n_pairs) * n_words
                 + pair_words * QF_THREADS) + 2 * n_tops * QF_THREADS)


# -- the kernels' wrappers -----------------------------------------------------

_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_K_QF = ("quorum_flags_launch",
         [_VP, _I64, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT, _VP,
          _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP])
_K_QC = ("quorum_compact_launch",
         [_VP, _VP, _VP, _VP, _VP, _VP, _I64, _I64, _INT, _INT, _VP, _VP, _VP,
          _VP])


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flags_kernel(rows, bound, remaining, scc_words, tables: FlagTables,
                 alive, is_q, wit, *, meta=None, bit=None) -> None:
    """Launch K-QF on `bound` child rows of `rows`, writing their flags to
    the bool tensors alive, is_q and wit.  With `meta` and `bit` (a segment
    depth) the children are the live frontier rows and those rows | bit,
    the live count read from meta on the card; `bound` must be at least
    twice it.  Takes tensors the caller has checked."""
    n, pair_words = tables.node_pairs.shape
    n_tops, n_words = tables.tops.shape
    _cuda_build.launch(
        "quorum", "K-QF", _K_QF, rows.device, rows.data_ptr(), bound,
        _ptr(meta), _ptr(bit), remaining.data_ptr(), scc_words.data_ptr(),
        n, n_tops, tables.pairs.shape[0], pair_words, n_words,
        *(_ptr(t) for t in tables), alive.data_ptr(), is_q.data_ptr(),
        wit.data_ptr())
    flags_kernel.launches += 1


flags_kernel.launches = 0


def compact_kernel(src, bit, alive, is_q, wit, tiles, bound, depth, meta,
                   dst, w_rows) -> None:
    """Launch K-QC for segment depth `depth`: compact the alive children
    of the live rows of `src` (flags from K-QF, `bound` children at most)
    into `dst`, the first WITNESS_CAP witness rows into w_rows [CAP, W],
    and update meta.  `tiles` is scratch of 2 ceil(bound / QC_TILE) int64."""
    capacity, n_words = src.shape
    _cuda_build.launch(
        "quorum", "K-QC", _K_QC, src.device, src.data_ptr(), bit.data_ptr(),
        alive.data_ptr(), is_q.data_ptr(), wit.data_ptr(), tiles.data_ptr(),
        bound, capacity, n_words, depth, meta.data_ptr(), dst.data_ptr(),
        w_rows.data_ptr())
    compact_kernel.launches += 1


compact_kernel.launches = 0


def _check_map(what, dev, top_thr, top_masks, inner_thr, inner_masks,
               tables: Optional[FlagTables], *masks) -> None:
    """Check the map's tables, K-QF's form of them and the one-row
    `masks` for a kernel on `dev`."""
    n, n_words = top_masks.shape
    k = inner_thr.shape[1] if inner_thr.dim() == 2 else -1
    _cuda_build.check_tensors(
        what, dev, (top_thr, torch.int32, (n,)),
        (top_masks, torch.int64, (n, n_words)),
        (inner_thr, torch.int32, (n, k)),
        (inner_masks, torch.int64, (n, k, n_words)),
        *((m, torch.int64, (n_words,)) for m in masks))
    if not 1 <= n_words <= MAX_WORDS:
        raise ValueError(f"{what}: {n_words} words a row; the kernel takes "
                         f"1 to {MAX_WORDS} ({MAX_NODES} nodes)")
    if tables is None:
        raise ValueError(f"{what}: K-QF needs the map's flag_tables")
    n_tops, n_pairs = tables.tops.shape[0], tables.pairs.shape[0]
    pair_words = tables.node_pairs.shape[1]
    _cuda_build.check_tensors(
        what, dev, (tables.top_thr, torch.int32, (n,)),
        (tables.top_of, torch.int32, (n,)),
        (tables.tops, torch.int64, (n_tops, n_words)),
        (tables.pair_thr, torch.int32, (n_pairs,)),
        (tables.pairs, torch.int64, (n_pairs, n_words)),
        (tables.node_pairs, torch.int64, (n, pair_words)))
    if pair_words != -(-n_pairs // 32):
        raise ValueError(f"{what}: {pair_words} words of pair bits for "
                         f"{n_pairs} pairs")
    if flags_smem_bytes(tables) > FLAGS_SMEM_MAX:
        raise ValueError(f"{what}: the map's tables take "
                         f"{flags_smem_bytes(tables)} bytes of shared memory; "
                         f"the kernel takes at most {FLAGS_SMEM_MAX}")


def prune_step(children, remaining, scc_words, top_thr, top_masks,
               inner_thr, inner_masks, *, tables: Optional[FlagTables] = None):
    """(alive, is_quorum, witness) [B] bool of child rows [B, W]: K-QF on a
    CUDA tensor, the plain version on a CPU one.  `tables`, K-QF's form of
    the map (flag_tables), is needed on CUDA."""
    if children.device.type == "cpu":
        return prune_step_plain(children, remaining, scc_words, top_thr,
                                top_masks, inner_thr, inner_masks)
    dev = children.device
    _check_map("prune_step", dev, top_thr, top_masks, inner_thr,
                        inner_masks, tables, remaining, scc_words)
    b = children.shape[0]
    _cuda_build.check_tensors("prune_step", dev,
                              (children, torch.int64, (b, top_masks.shape[1])))
    out = torch.empty((3, b), dtype=torch.bool, device=dev)
    if b:
        flags_kernel(children, b, remaining, scc_words, tables, out[0],
                     out[1], out[2])
    return out[0], out[1], out[2]


def segment_step(frontier, count, bits_seq, rems_seq, active_seq,
                 scc_words, top_thr, top_masks, inner_thr, inner_masks, *,
                 tables: Optional[FlagTables] = None):
    """segment_step_plain's contract.  On a CUDA frontier each active depth
    is K-QF + K-QC, launched back to back with no host sync; `count` is the
    host's int, `active_seq` a host sequence, `tables` as for prune_step.
    The input frontier is not written: the depths alternate between two
    new buffers of its shape."""
    if frontier.device.type == "cpu":
        return segment_step_plain(frontier, count, bits_seq, rems_seq,
                                  active_seq, scc_words, top_thr, top_masks,
                                  inner_thr, inner_masks)
    dev = frontier.device
    capacity, n_words = frontier.shape[0], top_masks.shape[1]
    _check_map("segment_step", dev, top_thr, top_masks, inner_thr,
                        inner_masks, tables, scc_words)
    _cuda_build.check_tensors(
        "segment_step", dev, (frontier, torch.int64, (capacity, n_words)),
        (bits_seq, torch.int64, (SEG_DEPTHS, n_words)),
        (rems_seq, torch.int64, (SEG_DEPTHS, n_words)))
    count = int(count)
    if not 0 <= count <= capacity:
        raise ValueError(f"segment_step: count {count} outside [0, {capacity}]")
    active = np.asarray(active_seq, dtype=bool)
    depths = [d for d in range(SEG_DEPTHS) if active[d]]
    # meta as segment_step_plain returns it, then the kernels' scratch slot
    meta = upload(np.array([0] * (2 * SEG_DEPTHS) + [count, -1, 0],
                           dtype=np.int32), dev)
    w_rows = torch.zeros((SEG_DEPTHS, WITNESS_CAP, n_words),
                         dtype=torch.int64, device=dev)
    if not depths or count == 0:
        return frontier, meta[:2 * SEG_DEPTHS + 2], w_rows
    # depth i of the segment has at most 2 min(C, count << i) children
    bounds = [2 * min(capacity, count << i) for i in range(len(depths))]
    flags = torch.empty((3, bounds[-1]), dtype=torch.bool, device=dev)
    tiles = torch.empty(2 * -(-bounds[-1] // QC_TILE), dtype=torch.int64,
                        device=dev)
    outs = (torch.empty_like(frontier), torch.empty_like(frontier))
    src = frontier
    for i, d in enumerate(depths):
        dst = outs[i % 2]
        flags_kernel(src, bounds[i], rems_seq[d], scc_words, tables,
                     flags[0], flags[1], flags[2], meta=meta, bit=bits_seq[d])
        compact_kernel(src, bits_seq[d], flags[0], flags[1], flags[2], tiles,
                       bounds[i], d, meta, dst, w_rows[d])
        src = dst
    return src, meta[:2 * SEG_DEPTHS + 2], w_rows


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# -- the checker ---------------------------------------------------------------

class CudaQuorumIntersectionChecker:
    """The reference's TPUQuorumIntersectionChecker (quorum.py:274-616): the
    same verdict contract as the CPU QuorumIntersectionChecker for maps in
    the flattened two-level (org) form of at most MAX_NODES nodes
    (ValueError otherwise).  Runs on the current card unless device="cpu";
    `devices`, a sequence (a card may repeat), shards every depth's
    prune_step over them, as the reference's `mesh` does."""

    # Capacity buckets of the device-resident frontier: the reference's
    # ladder (quorum.py:519), kept so a map takes the same path, with the
    # same chunked depths and overflow freezes, as on the reference.
    CAPACITY_BUCKETS = (1024, 4096, 16384, 65536, 262144, 1048576, 4194304)

    def __init__(self, qmap: Dict[bytes, object],
                 interrupt: Optional[Callable[[], bool]] = None,
                 batch_size: Optional[int] = None, *, device=None,
                 devices=None):
        if devices is not None:
            if device is not None:
                raise ValueError("pass device or devices, not both")
            self.devices = resolve_all(devices)
        else:
            self.devices = (resolve(device),)
        self.device = self.devices[0]
        self._shards = Shards(self.devices)
        (self.node_ids, tops, top_masks, inner_thrs,
         inner_masks) = flatten_qmap(qmap)
        self.n = len(self.node_ids)
        if self.n > MAX_NODES:
            raise ValueError(f"{self.n} nodes: the CUDA path takes at most "
                             f"{MAX_NODES} ({MAX_WORDS} words a row)")
        self.interrupt = interrupt or (lambda: False)
        # rows of one prune_step on the chunked path
        self.batch_size = 65536 if batch_size is None else batch_size
        # the CPU oracle sorts node ids as flatten_qmap does: SCC analysis
        # and the re-check of every witness
        self.oracle = QuorumIntersectionChecker(qmap, interrupt)
        assert self.oracle.node_ids == self.node_ids

        self.n_words = max((self.n + 31) // 32, 1)
        k = max(max((len(t) for t in inner_thrs), default=0), 1)
        n, w = self.n, self.n_words
        thr = np.full((n, k), _PAD_THR, dtype=np.int32)
        imask = np.zeros((n, k, w), dtype=np.int64)
        for i in range(n):
            for j, t in enumerate(inner_thrs[i]):
                thr[i, j] = t
                imask[i, j] = _masks_to_words([inner_masks[i][j]], w)[0]
        # the map and K-QF's form of it, made once on each device
        self._maps = {}
        for dev in dict.fromkeys(self.devices):
            tensors = (upload(np.asarray(tops, dtype=np.int32), dev),
                       upload(_masks_to_words(top_masks, w), dev),
                       upload(thr, dev), upload(imask, dev))
            self._maps[dev] = (tensors, flag_tables(*tensors))
        (self.top_thr, self.top_masks, self.inner_thr,
         self.inner_masks), self.tables = self._maps[self.device]
        # what the reference mirrors into its accel.quorum.* metrics
        self.stats = {"checks": 0, "nodes": self.n, "frontier_peak": 0,
                      "quorum_hits": 0}
        # set by check() once the quorum-bearing SCC is known
        self._scc_words = None
        self._scc_dev = None     # on the first device
        self._scc_on = {}        # device -> scc words there

    def _map(self):
        return self.top_thr, self.top_masks, self.inner_thr, self.inner_masks

    # -- batched pruning on the card(s) --------------------------------------
    def _prune(self, children: np.ndarray, remaining_words: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Flags of `children`, batch_size rows a chunk, each chunk split
        over the devices; a shard's flags come home once its event fires."""
        flags = np.zeros((3, len(children)), dtype=bool)
        bs = self.batch_size
        shards = self._shards
        rems = []
        for k in range(len(shards)):
            with shards.on(k) as dev:
                rems.append(upload(remaining_words, dev))
        for lo in range(0, len(children), bs):
            if self.interrupt():
                raise InterruptedError_()
            chunk = children[lo:lo + bs]
            pending = []
            for k, (a, b) in enumerate(parts(len(chunk), len(shards))):
                if a == b:
                    continue
                with shards.on(k) as dev:
                    (maps, tables) = self._maps[dev]
                    out = torch.stack(prune_step(
                        upload(chunk[a:b], dev), rems[k], self._scc_on[dev],
                        *maps, tables=tables))
                pending.append((lo + a, lo + b, out, shards.join(k, out)))
            for a, b, out, event in pending:
                if event is not None:
                    event.synchronize()
                flags[:, a:b] = out.cpu().numpy()
        return flags[0], flags[1], flags[2]

    # -- the frontier search ------------------------------------------------
    def check(self) -> QuorumIntersectionResult:
        # both accumulators reset here: an aborted run must not re-count the
        # previous check()'s hits in the finally block below
        self._frontier_peak = 0
        self._quorum_hits = 0
        self.stats["checks"] += 1
        try:
            return self._check()
        finally:
            self.stats["frontier_peak"] = max(self.stats["frontier_peak"],
                                              self._frontier_peak)
            self.stats["quorum_hits"] += self._quorum_hits

    def _check(self) -> QuorumIntersectionResult:
        oracle = self.oracle
        n = self.n
        if n == 0:
            return QuorumIntersectionResult(True, node_count=0)

        # SCC phase on the CPU (cheap, irregular graph walk)
        oracle._indegree = indeg = [0] * n
        for qb in oracle.qbs:
            m = qb.successors
            while m:
                bit = m & -m
                indeg[bit.bit_length() - 1] += 1
                m ^= bit
        sccs = tarjan_sccs([qb.successors for qb in oracle.qbs], n)
        quorum_sccs = [(s, mq) for s in sccs
                       if (mq := oracle.contract_to_max_quorum(s))]
        if not quorum_sccs:
            return QuorumIntersectionResult(True, node_count=n,
                                            main_scc_size=0)
        if len(quorum_sccs) > 1:
            (_, q1), (_, q2) = quorum_sccs[0], quorum_sccs[1]
            return QuorumIntersectionResult(
                False, split=(oracle._names(q1), oracle._names(q2)),
                node_count=n, main_scc_size=0)
        scc, _ = quorum_sccs[0]

        # global variable order: in-degree desc (a fixed order is what lets
        # the frontier share masks)
        order = sorted((i for i in range(n) if (scc >> i) & 1),
                       key=lambda i: -indeg[i])
        depth_remaining = [0] * (len(order) + 1)
        for d in range(len(order) - 1, -1, -1):
            depth_remaining[d] = depth_remaining[d + 1] | (1 << order[d])

        D = len(order)
        bits_all = _masks_to_words([1 << order[d] for d in range(D)],
                                   self.n_words)
        rems_all = _masks_to_words(depth_remaining[1:D + 1], self.n_words)
        self._scc_words = _masks_to_words([scc], self.n_words)[0]
        self._scc_on = {dev: upload(self._scc_words, dev) for dev in self._maps}
        self._scc_dev = self._scc_on[self.device]

        self._quorum_hits = 0

        def process_witness(words) -> QuorumIntersectionResult:
            """A device-reported split witness: committed claims to be a
            quorum whose scc-complement contains one.  BOTH sides are
            re-verified on the exact CPU oracle before the verdict leaves
            this class: a device fault must fail-stop, never fabricate a
            'proven non-intersection'."""
            committed = _words_to_mask(words)
            if not oracle.is_quorum(committed):
                raise RuntimeError(
                    "device split witness rejected by CPU oracle: committed "
                    "set is not a quorum (device fault?)")
            disjoint = oracle.contract_to_max_quorum(scc & ~committed)
            if not disjoint:
                raise RuntimeError(
                    "device split witness rejected by CPU oracle: "
                    "complement has no quorum (device fault?)")
            return QuorumIntersectionResult(
                False,
                split=(oracle._names(committed), oracle._names(disjoint)),
                node_count=n, main_scc_size=scc.bit_count(),
                max_quorums_found=self._quorum_hits)

        if len(self.devices) > 1:
            res = self._run_chunked(bits_all, rems_all, process_witness)
        else:
            res = self._run_resident(bits_all, rems_all, process_witness)
        if res is not None:
            return res
        return QuorumIntersectionResult(
            True, node_count=n, main_scc_size=scc.bit_count(),
            max_quorums_found=self._quorum_hits)

    def _run_chunked(self, bits_all, rems_all, process_witness
                     ) -> Optional[QuorumIntersectionResult]:
        """Per-depth host-chunked frontier walk: the reference's path under
        a mesh (quorum.py:478-490), taken with several devices (a resident
        frontier's compaction would be shard-local)."""
        frontier = np.zeros((1, self.n_words), dtype=np.int64)  # committed=0
        for d in range(len(bits_all)):
            if len(frontier) == 0:
                break
            frontier, res = self._chunked_depth(frontier, bits_all[d],
                                                rems_all[d], process_witness)
            self._note_frontier(len(frontier))
            if res is not None:
                return res
        return None

    def _note_frontier(self, width: int) -> None:
        self._frontier_peak = max(self._frontier_peak, width)

    def _chunked_depth(self, frontier, bit_words, rem_words, process_witness):
        """Expand + prune ONE depth with the frontier on the host, in
        batch_size chunks; returns (new_frontier, early_result_or_None)."""
        children = np.concatenate([frontier, frontier | bit_words])
        alive, is_q, wit = self._prune(children, rem_words)
        self._quorum_hits += int(is_q.sum())
        w_idx = np.nonzero(wit)[0]
        if len(w_idx):
            return children[alive], process_witness(children[w_idx[0]])
        return children[alive], None

    def _run_resident(self, bits_all, rems_all, process_witness
                      ) -> Optional[QuorumIntersectionResult]:
        """Device-resident frontier walk: SEG_DEPTHS depths per segment,
        compaction on the card; per segment the host syncs the meta, the
        witness rows only when a depth found one, and the frontier only
        when a depth falls back to the host-chunked path."""
        D = len(bits_all)
        W = self.n_words
        fr_host = np.zeros((1, W), dtype=np.int64)
        fr_dev = None        # resident [cur_cap, W] when not None
        cur_cap = None
        count = 1
        d = 0

        def to_host(n):
            return _host(fr_dev[:n]) if fr_dev is not None else fr_host[:n]

        while d < D and count > 0:
            self._note_frontier(count)
            if self.interrupt():
                raise InterruptedError_()
            # worst case the frontier doubles every depth of the segment;
            # bucket >= need means in-segment overflow is only possible at
            # the largest bucket
            need = count << SEG_DEPTHS
            cap = next((c for c in self.CAPACITY_BUCKETS if c >= need),
                       self.CAPACITY_BUCKETS[-1])
            if count * 2 > cap:
                # frontier too wide even for the largest bucket: finish
                # this depth host-chunked, then retry residency
                fr_host, res = self._chunked_depth(
                    to_host(count), bits_all[d], rems_all[d],
                    process_witness)
                fr_dev = None
                if res is not None:
                    return res
                count = len(fr_host)
                d += 1
                continue
            k = min(SEG_DEPTHS, D - d)
            bits = np.zeros((SEG_DEPTHS, W), dtype=np.int64)
            rems = np.zeros((SEG_DEPTHS, W), dtype=np.int64)
            active = np.zeros(SEG_DEPTHS, dtype=bool)
            bits[:k] = bits_all[d:d + k]
            rems[:k] = rems_all[d:d + k]
            active[:k] = True
            if fr_dev is None or cur_cap != cap:
                fr_in = torch.zeros((cap, W), dtype=torch.int64,
                                    device=self.device)
                fr_in[:count] = (fr_dev[:count] if fr_dev is not None
                                 else upload(fr_host[:count], self.device))
            else:
                fr_in = fr_dev   # already resident at this capacity
            # looked up in the module at each call, so a test can swap it
            fr, meta, w_rows = segment_step(
                fr_in, count, upload(bits, self.device),
                upload(rems, self.device), active, self._scc_dev,
                *self._map(), tables=self.tables)
            # the segment's one sync: per-depth hit/witness counts, count'
            # and the overflow depth in one transfer
            meta = _host(meta)
            q_counts = meta[:SEG_DEPTHS]
            w_counts = meta[SEG_DEPTHS:2 * SEG_DEPTHS]
            count = int(meta[2 * SEG_DEPTHS])
            ovf = int(meta[2 * SEG_DEPTHS + 1])
            fr_dev, cur_cap = fr, cap
            done_depths = k if ovf < 0 else min(ovf, k)
            if w_counts[:done_depths].any():
                # count quorum hits only up to and including the witnessing
                # depth, so max_quorums_found matches the CPU oracle's count
                # at the moment the split is found
                rows = _host(w_rows)
                for j in range(done_depths):
                    if w_counts[j]:
                        self._quorum_hits += int(q_counts[:j + 1].sum())
                        return process_witness(rows[j, 0])
            self._quorum_hits += int(q_counts[:done_depths].sum())
            if ovf >= 0:
                # the overflow depth never ran: state froze at its input --
                # finish that depth host-chunked and continue
                fr_host, res = self._chunked_depth(
                    to_host(count), bits_all[d + ovf], rems_all[d + ovf],
                    process_witness)
                fr_dev = None
                if res is not None:
                    return res
                count = len(fr_host)
                d += ovf + 1
            else:
                d += k
        return None


def check_intersection_cuda(qmap, interrupt=None, batch_size=None, *,
                            device=None, devices=None
                            ) -> QuorumIntersectionResult:
    """One-shot API mirroring the reference's check_intersection_tpu
    (`devices` in place of its `mesh`)."""
    return CudaQuorumIntersectionChecker(qmap, interrupt, batch_size,
                                         device=device, devices=devices).check()
