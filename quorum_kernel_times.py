#!/usr/bin/env python3
"""Time one checkout's quorum kernels, K-QF and K-QC, on the card.

    python3 quorum_kernel_times.py [--tree DIR]

Imports the port from DIR (default: this checkout), so that two versions
of the kernels can be timed in one call on one card: run parent, change,
change, parent.  Times are CUDA events around each launch, with
chip_smoke.py's event_ms:

* asym7's widest depth, 11,649,024 children of its 5,824,512-row frontier
  peak, taken where the checker reaches it (a one-depth segment_step, or a
  host-chunked depth in checkouts that chunk it on the host): K-QF over
  the children in one prune_step launch, and K-QC in a segment_step of
  that one depth into twice the frontier's rows;
* K-QF on 65,536 random child rows (chip_smoke.py's random_prune_args) of
  asym7 (one node class) and of rings of 16 and 64 nodes (16 and 64
  classes, each node its own top mask).

Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ASYM7_FRONTIER_PEAK = 5_824_512
ROWS = 65536


class _Found(Exception):
    """Ends the check's walk at the depth wanted."""


def widest_depth(quorum, qmap, peak: int):
    """(checker, frontier [peak, W], bit, remaining) of the depth whose
    input frontier has `peak` rows, as the checker reaches it."""
    import torch
    checker = quorum.CudaQuorumIntersectionChecker
    ck = checker(qmap)
    found = []
    real_step, real_chunk = quorum.segment_step, checker._chunked_depth

    def step(fr, count, bits, rems, *args, **kw):
        if count == peak:
            found.append((fr[:count], bits[0], rems[0]))
            raise _Found
        return real_step(fr, count, bits, rems, *args, **kw)

    def chunk(self, frontier, bit, rem, witness):
        if len(frontier) == peak:
            found.append(tuple(torch.from_numpy(a).to(self.device)
                               for a in (frontier, bit, rem)))
            raise _Found
        return real_chunk(self, frontier, bit, rem, witness)

    quorum.segment_step, checker._chunked_depth = step, chunk
    try:
        ck.check()
    except _Found:
        pass
    finally:
        quorum.segment_step, checker._chunked_depth = real_step, real_chunk
    return (ck, *found[0])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", help="import the port from this checkout")
    args = p.parse_args(argv)
    if args.tree:
        sys.path.insert(0, str(Path(args.tree).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("quorum_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    from stellar_core_tpu_torch import testutils
    from stellar_core_tpu_torch.accel import quorum
    # this checkout's chip_smoke.py (timers, random rows), over the port
    # imported above
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    t0 = time.perf_counter()

    ck, fr, bit, rem = widest_depth(quorum, testutils.asym_org_qmap(7),
                                    ASYM7_FRONTIER_PEAK)
    children = torch.cat([fr, fr | bit[None]])
    qf = (children, rem, ck._scc_dev, *ck._map())
    n, w = len(fr), ck.n_words
    buf = torch.zeros((2 * n, w), dtype=torch.int64, device=ck.device)
    buf[:n] = fr
    bits = torch.zeros((quorum.SEG_DEPTHS, w), dtype=torch.int64,
                       device=ck.device)
    rems = bits.clone()
    bits[0], rems[0] = bit, rem
    one = np.array([True] + [False] * (quorum.SEG_DEPTHS - 1))
    seg = (buf, n, bits, rems, one, ck._scc_dev, *ck._map())
    out = {"tree": args.tree or ".", "module": quorum.__file__,
           "widest": {
               "children": len(children),
               "K-QF_ms": smoke.event_ms(
                   lambda: quorum.prune_step(*qf, tables=ck.tables), "K-QF",
                   5),
               "K-QC_ms": smoke.event_ms(
                   lambda: quorum.segment_step(*seg, tables=ck.tables),
                   "K-QC", 5)}}
    del buf, seg, qf, children, fr

    for name, qmap in (("asym7", testutils.asym_org_qmap(7)),
                       ("rings16", testutils.adversarial_quorum_map(16)),
                       ("rings64", testutils.adversarial_quorum_map(64))):
        ck = quorum.CudaQuorumIntersectionChecker(qmap)
        qf = smoke.random_prune_args(ck, ROWS)
        out[name] = {"nodes": ck.n, "K-QF_ms": smoke.event_ms(
            lambda: quorum.prune_step(*qf, tables=ck.tables), "K-QF", 20)}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
