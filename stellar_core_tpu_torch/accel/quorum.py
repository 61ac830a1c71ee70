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
  fixpoint a loop of the thread's own over the map's node classes.
  ``prune_step`` launches it on a batch of children; each depth of
  ``segment_step`` launches it on the frontier itself, child t < n being
  fr[t] and child n + t being fr[t] | bit.  Rows of up to 8 words with
  tables that fit shared memory take the fast path; wider rows and larger
  tables take the wide paths (``flags_path``).
- **K-QC** (``compact_kernel``) replaces the rest of a ``_segment_step``
  depth (:236-263): the stable compaction of the alive children (exclude
  branch first, then include branch, each in index order, as
  ``argsort(~alive)`` orders them), the first WITNESS_CAP witness rows in
  the same order, the per-depth counts and the freeze on overflow, in one
  launch.

A segment runs its SEG_DEPTHS depths back to back on the current stream;
the live count, the overflow depth and the meta stay on the card, and the
host syncs once per segment, on the meta.  A depth the reference runs
host-chunked (its frontier too wide for the top capacity bucket, or the
depth after an overflow freeze) runs here as a segment of that one depth
into a buffer of twice the frontier's rows: the frontier never leaves the
card.

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
# Depths fused per segment, and the per-depth capacity of the witness rows
# (the reference's values: the same map takes the same path).
SEG_DEPTHS = 4
WITNESS_CAP = 8
# children a K-QC tile holds (csrc/quorum.cu: 256 threads x 8)
QC_TILE = 2048
# K-QF's block size and the shared memory a block may opt in to on sm_90
# (csrc/quorum.cu: QF_THREADS, MAX_SMEM); the widths of the fast path (its
# template instances) and the most pair words whose results a thread keeps
# in registers (csrc/quorum.cuh: QR_PAIR_WORDS); the threads of a wide-path
# launch at most (each with its own scratch)
QF_THREADS = 128
FLAGS_SMEM_MAX = 232448
FAST_WORDS = 8
QR_PAIR_WORDS = 2
QF_WIDE_THREADS = 65536
# meta's slots beyond segment_step_plain's: which buffer holds the live
# frontier (0: the segment's input)
M_BUF = 2 * SEG_DEPTHS + 2


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
                       inner_masks, *, capacity=None):
    """SEG_DEPTHS frontier depths: the reference's _segment_step
    (quorum.py:195-271).  frontier [C, W] (rows >= count are padding);
    returns (frontier', meta [2 SEG_DEPTHS + 2] int32 = per-depth quorum
    hits ++ per-depth witnesses ++ [count', overflow depth or -1],
    w_rows [SEG_DEPTHS, WITNESS_CAP, W]).  A depth whose alive children
    exceed `capacity` (default C) leaves the state as it was (its counts 0)
    and ends the segment.  Only frontier'[:count'] and
    w_rows[j, :witnesses_j] mean anything."""
    n_words = frontier.shape[1]
    if capacity is None:
        capacity = frontier.shape[0]
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
        fr = torch.zeros((capacity, n_words), dtype=torch.int64,
                         device=frontier.device)
        fr[:len(kept)] = kept
        cnt = len(kept)
        meta[d], meta[SEG_DEPTHS + d] = q, w
        w_rows[d] = rows
    meta[2 * SEG_DEPTHS:] = [cnt, ovf]
    return (fr, torch.tensor(meta, dtype=torch.int32, device=frontier.device),
            w_rows)


# -- K-QF's form of the map ---------------------------------------------------

class FlagArrays(NamedTuple):
    """K-QF's form of a map, as host arrays: each distinct top mask and
    each distinct satisfiable inner (mask, threshold) pair once (a pair a
    node's qset holds twice is two pairs); per node its top threshold, the
    index of its top mask and its pairs as a bitmask; and the nodes grouped
    into classes of equal (top threshold, top mask, pairs), each with the
    mask of its members."""
    top_thr: np.ndarray        # [N] int32
    top_of: np.ndarray         # [N] int64
    tops: np.ndarray           # [T, W] int64 words
    pair_thr: np.ndarray       # [P] int64
    pairs: np.ndarray          # [P, W] int64 words
    node_pairs: np.ndarray     # [N, ceil(P / 32)] int64 words
    class_thr: np.ndarray      # [C] int64
    class_top: np.ndarray      # [C] int64
    class_pairs: np.ndarray    # [C, ceil(P / 32)] int64 words
    class_members: np.ndarray  # [C, W] int64 words


class FlagTables(NamedTuple):
    """A map as K-QF reads it: flag_arrays' class and set tables as one
    array of 32-bit words on the map's device, in csrc/quorum.cuh's
    q_blob_words order, and their sizes (csrc/quorum.cuh's QDims)."""
    blob: torch.Tensor                   # int32
    dims: Tuple[int, int, int, int, int]  # classes, tops, pairs,
    #                                       pair words, words a row


def flag_arrays(top_thr, top_masks, inner_thr, inner_masks) -> FlagArrays:
    """K-QF's form of a map given as flatten_qmap's padded tensors.  Inner
    pairs above 32 W (the padding) are never satisfied and are left out."""
    tt, tm, it, im = (_host(a) for a in (top_thr, top_masks, inner_thr,
                                         inner_masks))
    n, k, n_words = im.shape
    tops, top_of = np.unique(tm, axis=0, return_inverse=True)
    top_of = top_of.reshape(-1)
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
    node_pairs = _masks_to_words(node_bits, -(-len(pairs) // 32))
    # node classes: equal (top threshold, top mask, pairs)
    keys = np.concatenate([tt.reshape(n, 1).astype(np.int64),
                           top_of.reshape(n, 1).astype(np.int64), node_pairs],
                          axis=1)
    classes, class_of = np.unique(keys, axis=0, return_inverse=True)
    class_of = class_of.reshape(-1)
    members = _masks_to_words(
        [sum(1 << int(i) for i in np.nonzero(class_of == c)[0])
         for c in range(len(classes))], n_words)
    return FlagArrays(
        tt, top_of, tops, np.array(pair_thr, dtype=np.int64),
        np.array(pairs, dtype=np.int64).reshape(-1, n_words), node_pairs,
        classes[:, 0], classes[:, 1], np.ascontiguousarray(classes[:, 2:]),
        members)


def flag_tables(top_thr, top_masks, inner_thr, inner_masks) -> FlagTables:
    """K-QF's tables of a map given as flatten_qmap's padded tensors, on
    their device (flag_arrays, packed)."""
    a = flag_arrays(top_thr, top_masks, inner_thr, inner_masks)
    blob = np.concatenate([
        a.class_thr, a.class_top, a.pair_thr, a.class_pairs.reshape(-1),
        a.tops.reshape(-1), a.pairs.reshape(-1), a.class_members.reshape(-1)])
    # 32-bit words: the masks' bits and the thresholds as they are
    return FlagTables(upload(blob.astype(np.uint32).view(np.int32),
                             top_masks.device),
                      (len(a.class_thr), len(a.tops), len(a.pairs),
                       a.node_pairs.shape[1], a.tops.shape[1]))


def regs_fit(tables: FlagTables) -> bool:
    """Does a row's slice-pass results fit in registers (q_regs_fit)?"""
    return tables.dims[3] <= QR_PAIR_WORDS


def flags_smem_bytes(tables: FlagTables) -> int:
    """Shared memory K-QF takes for `tables` with them in shared memory
    (csrc/quorum.cuh's q_flags_smem): the blob, and on the fast path (rows
    of at most FAST_WORDS words) each thread's slice-pass results unless
    they are in registers.  The wide paths keep those in scratch."""
    d = tables.dims
    blob = 4 * tables.blob.numel()
    if d[4] > FAST_WORDS or regs_fit(tables):
        return blob
    return blob + 4 * QF_THREADS * d[3]


def flags_path(tables: FlagTables) -> str:
    """K-QF's path for a map: "fast" (rows of at most FAST_WORDS words,
    tables in shared memory), "wide" (wider rows, tables in shared
    memory) or "global" (tables too large for shared memory, read in
    place)."""
    if flags_smem_bytes(tables) > FLAGS_SMEM_MAX:
        return "global"
    return "fast" if tables.dims[4] <= FAST_WORDS else "wide"


# -- the kernels' wrappers -----------------------------------------------------

_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_K_QF = ("quorum_flags_launch",
         [_VP, _I64, _VP, _VP, _VP, _VP, _VP, _I64, _INT, _INT, _INT, _INT,
          _INT, _INT, _VP, _I64, _VP, _VP, _VP, _VP])
_K_QC = ("quorum_compact_launch",
         [_VP, _VP, _VP, _VP, _VP, _VP, _I64, _I64, _INT, _INT, _INT, _VP,
          _VP, _VP, _VP])
_PATHS = {"fast": 0, "wide": 1, "global": 2}


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flags_kernel(rows, bound, remaining, scc_words, tables: FlagTables,
                 alive, is_q, wit, *, meta=None, bit=None) -> None:
    """Launch K-QF on `bound` child rows of `rows`, writing their flags to
    the bool tensors alive, is_q and wit.  With `meta` and `bit` (a segment
    depth) the children are the live frontier rows and those rows | bit,
    the live count read from meta on the card; `bound` must be at least
    twice it.  The wide paths get their threads' scratch here.  Takes
    tensors the caller has checked."""
    d = tables.dims
    path = flags_path(tables)
    scratch, threads = None, 0
    if path != "fast":
        threads = min(-(-bound // QF_THREADS) * QF_THREADS, QF_WIDE_THREADS)
        words = 5 * d[4] + d[3]     # q_wide_scratch_words
        scratch = torch.empty(words * threads, dtype=torch.int32,
                              device=rows.device)
    _cuda_build.launch(
        "quorum", "K-QF", _K_QF, rows.device, rows.data_ptr(), bound,
        _ptr(meta), _ptr(bit), remaining.data_ptr(), scc_words.data_ptr(),
        tables.blob.data_ptr(), tables.blob.numel(), *d, _PATHS[path], _ptr(scratch), threads,
        alive.data_ptr(), is_q.data_ptr(), wit.data_ptr())
    flags_kernel.launches += 1


flags_kernel.launches = 0


def compact_kernel(src, bit, alive, is_q, wit, state, bound, capacity,
                   depth, dst_id, meta, dst, w_rows) -> None:
    """Launch K-QC for segment depth `depth`: compact the alive children
    of the live rows of `src` (flags from K-QF, `bound` children at most)
    into `dst` (`capacity` rows; buffer number dst_id, which meta names if
    the depth does not overflow), the first WITNESS_CAP witness rows into
    w_rows [CAP, W], and update meta.  `state` is a zeroed int64 array of
    3 + ceil(bound / QC_TILE)."""
    _cuda_build.launch(
        "quorum", "K-QC", _K_QC, src.device, src.data_ptr(), bit.data_ptr(),
        alive.data_ptr(), is_q.data_ptr(), wit.data_ptr(), state.data_ptr(),
        bound, capacity, src.shape[1], depth, dst_id, meta.data_ptr(),
        dst.data_ptr(), w_rows.data_ptr())
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
    if n_words < 1:
        raise ValueError(f"{what}: rows of {n_words} words")
    if tables is None:
        raise ValueError(f"{what}: K-QF needs the map's flag_tables")
    _, _, n_pairs, pair_words, w = tables.dims
    _cuda_build.check_tensors(what, dev, (tables.blob, torch.int32,
                                          (tables.blob.numel(),)))
    if w != n_words or pair_words != -(-n_pairs // 32):
        raise ValueError(f"{what}: flag tables of {tables.dims} (classes, "
                         f"tops, pairs, pair words, words) for rows of "
                         f"{n_words} words")


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
                 tables: Optional[FlagTables] = None, capacity=None):
    """segment_step_plain's contract.  On a CUDA frontier each active depth
    is K-QF + K-QC, launched back to back; `count` is the host's int,
    `active_seq` a host sequence, `tables` as for prune_step.  The input
    frontier is not written: the depths alternate between two new buffers
    of `capacity` rows (default the frontier's), and the frontier' returned
    is the buffer that meta names after the segment's one sync, the input
    itself if the first depth overflowed; so is the meta returned, on the
    host."""
    if frontier.device.type == "cpu":
        return segment_step_plain(frontier, count, bits_seq, rems_seq,
                                  active_seq, scc_words, top_thr, top_masks,
                                  inner_thr, inner_masks, capacity=capacity)
    dev = frontier.device
    n_words = top_masks.shape[1]
    capacity = frontier.shape[0] if capacity is None else int(capacity)
    _check_map("segment_step", dev, top_thr, top_masks, inner_thr,
               inner_masks, tables, scc_words)
    _cuda_build.check_tensors(
        "segment_step", dev,
        (frontier, torch.int64, (frontier.shape[0], n_words)),
        (bits_seq, torch.int64, (SEG_DEPTHS, n_words)),
        (rems_seq, torch.int64, (SEG_DEPTHS, n_words)))
    count = int(count)
    if not 0 <= count <= min(frontier.shape[0], capacity):
        raise ValueError(f"segment_step: count {count} outside [0, "
                         f"{min(frontier.shape[0], capacity)}]")
    bufs, meta, w_rows = enqueue_segment(frontier, count, bits_seq,
                                         rems_seq, active_seq, scc_words,
                                         tables, capacity)
    host = meta.cpu()         # the segment's one sync
    return bufs[int(host[M_BUF])], host[:M_BUF], w_rows


def enqueue_segment(frontier, count: int, bits_seq, rems_seq, active_seq,
                    scc_words, tables: FlagTables, capacity: int):
    """segment_step's launches on checked arguments, enqueued on the
    current stream with no host sync: (the buffers [input frontier, the
    depths' two outputs], meta on the card with M_BUF naming the buffer
    that holds the live frontier, w_rows)."""
    dev, n_words = frontier.device, frontier.shape[1]
    depths = [d for d in range(SEG_DEPTHS) if active_seq[d]]
    # meta as segment_step_plain returns it, then the buffer slot
    meta = upload(np.array([0] * (2 * SEG_DEPTHS) + [count, -1, 0],
                           dtype=np.int32), dev)
    w_rows = torch.zeros((SEG_DEPTHS, WITNESS_CAP, n_words),
                         dtype=torch.int64, device=dev)
    if not depths or count == 0:
        return [frontier], meta, w_rows
    # depth i of the segment has at most 2 min(C, count << i) children
    bounds = [2 * min(capacity, count << i) for i in range(len(depths))]
    top = max(bounds)
    flags = torch.empty((3, top), dtype=torch.bool, device=dev)
    state = torch.zeros((len(depths), 3 + -(-top // QC_TILE)),
                        dtype=torch.int64, device=dev)
    bufs = [frontier] + [torch.empty((capacity, n_words), dtype=torch.int64,
                                     device=dev)
                         for _ in range(min(2, len(depths)))]
    src = 0
    for i, d in enumerate(depths):
        dst = 1 + i % 2
        flags_kernel(bufs[src], bounds[i], rems_seq[d], scc_words, tables,
                     flags[0], flags[1], flags[2], meta=meta,
                     bit=bits_seq[d])
        compact_kernel(bufs[src], bits_seq[d], flags[0], flags[1], flags[2],
                       state[i], bounds[i], capacity, d, dst, meta,
                       bufs[dst], w_rows[d])
        src = dst
    return bufs, meta, w_rows


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# -- the checker ---------------------------------------------------------------

class CudaQuorumIntersectionChecker:
    """The reference's TPUQuorumIntersectionChecker (quorum.py:274-616): the
    same verdict contract as the CPU QuorumIntersectionChecker for maps in
    the flattened two-level (org) form, of any size (ValueError
    otherwise).  Runs on the current card unless device="cpu";
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
        compaction on the card; per segment the host syncs the meta, and
        the witness rows only when a depth found one.  A depth the
        reference runs host-chunked (the frontier too wide for the top
        bucket, or the depth after an overflow freeze) is a segment of
        that one depth into twice the frontier's rows, so the frontier
        never leaves the card."""
        D = len(bits_all)
        W = self.n_words
        dev = self.device
        # every depth's bit and remaining-mask, padded so that any depth's
        # SEG_DEPTHS rows are one contiguous slice
        pad = np.zeros((SEG_DEPTHS, W), dtype=np.int64)
        bits_dev = upload(np.concatenate([bits_all, pad]), dev)
        rems_dev = upload(np.concatenate([rems_all, pad]), dev)
        fr = torch.zeros((1, W), dtype=torch.int64, device=dev)  # committed=0
        cur_cap = None       # the bucket fr is, or None
        count = 1
        d = 0

        def run(fr_in, k, capacity):
            """Depths d .. d + k - 1 from fr_in: (frontier', count',
            overflow depth or -1, early result or None)."""
            active = np.zeros(SEG_DEPTHS, dtype=bool)
            active[:k] = True
            # looked up in the module at each call, so a test can swap it
            out, meta, w_rows = segment_step(
                fr_in, count, bits_dev[d:d + SEG_DEPTHS],
                rems_dev[d:d + SEG_DEPTHS], active, self._scc_dev,
                *self._map(), tables=self.tables, capacity=capacity)
            # the segment's one sync: per-depth hit/witness counts, count'
            # and the overflow depth in one transfer
            meta = _host(meta)
            q_counts = meta[:SEG_DEPTHS]
            w_counts = meta[SEG_DEPTHS:2 * SEG_DEPTHS]
            ovf = int(meta[2 * SEG_DEPTHS + 1])
            done_depths = k if ovf < 0 else min(ovf, k)
            if w_counts[:done_depths].any():
                # count quorum hits only up to and including the witnessing
                # depth, so max_quorums_found matches the CPU oracle's count
                # at the moment the split is found
                rows = _host(w_rows)
                for j in range(done_depths):
                    if w_counts[j]:
                        self._quorum_hits += int(q_counts[:j + 1].sum())
                        return out, 0, ovf, process_witness(rows[j, 0])
            self._quorum_hits += int(q_counts[:done_depths].sum())
            return out, int(meta[2 * SEG_DEPTHS]), ovf, None

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
                # frontier too wide even for the largest bucket: the
                # reference runs this depth host-chunked; here it is one
                # depth into 2 count rows, then residency is retried
                fr, count, _, res = run(fr, 1, 2 * count)
                if res is not None:
                    return res
                cur_cap = None
                d += 1
                continue
            k = min(SEG_DEPTHS, D - d)
            if cur_cap != cap:
                fr_in = torch.zeros((cap, W), dtype=torch.int64, device=dev)
                fr_in[:count] = fr[:count]
            else:
                fr_in = fr   # already resident at this capacity
            fr, count, ovf, res = run(fr_in, k, cap)
            if res is not None:
                return res
            cur_cap = cap
            if ovf >= 0:
                # the overflow depth never ran: state froze at its input --
                # finish that depth as the reference's chunked fallback
                # does, into 2 count rows, and continue
                d += ovf
                if self.interrupt():
                    raise InterruptedError_()
                fr, count, _, res = run(fr, 1, 2 * count)
                if res is not None:
                    return res
                cur_cap = None
                d += 1
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
