#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, portbench/ and
stellar_core_tpu_torch/.  The run makes its inputs from --seed, sets up
the port (stellar_core_tpu_torch) and warms every shape the cell uses,
measures for --seconds, then checks what the window produced against the
frozen reference (portbench/refcore) and prints, as the last line of
standard output, one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics with --trace 0, its per-layer metrics with
--trace 1) and device.  Each number compared is printed beside its limit
as the last lines of standard error and under "checks", the result's last
key.  Exits 3 without CUDA or with fewer cards than the cell asks for, 4
where a forbidden module (jax, jaxlib, flax, stellar_core_tpu) was
loaded, 2 where the checkout lacks what the cell needs; none of these
prints a result."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed directory of the
    checkout (build/ is never committed)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number")
    sys.path.insert(0, str(ROOT))
    _cache_dirs()
    try:
        from portbench.lib import harness
        cell = harness.find_cell(harness.load_benchmark(ROOT),
                                 args.workload)
        import stellar_core_tpu_torch  # noqa: F401  (the program)
    except (OSError, KeyError, ImportError) as e:
        print(f"portbench: cannot run {args.workload}: {e!r}",
              file=sys.stderr)
        return 2
    import torch
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    drv = harness.runner(cell["config"]).Cell(
        cell, args.seed, args.seconds, bool(args.trace))
    drv.setup()
    setup_end = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    window = drv.run()
    # a runner whose set-up goes on inside run() says when it ended
    setup_s = window.get("setup_end", setup_end) - T0
    torch.cuda.synchronize()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips,
              "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    trace = window.get("trace")
    if trace is not None:
        from portbench.lib import trace as tr
        device["busy_s"] = tr.union_s(trace.ops)
        device["window_s"] = trace.window_s
    drv.release()
    verdict = drv.check()
    if args.trace:
        ctx = harness.Context(window["registry"], trace, window["stats"])
        metrics = harness.read_metrics(cell["per_layer"], ctx)
    else:
        metrics = {m["name"]: {"value": window["end_to_end"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell["end_to_end"] if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        missing = [k for k, v in metrics.items() if v["value"] is None]
        if missing:
            print(f"portbench: no value for {missing}", file=sys.stderr)
            return 5
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 4
    out = {"correct": verdict["correct"], "attempted": verdict["attempted"],
           "failed": verdict["failed"], "metrics": metrics, "device": device}
    if trace is not None:
        out["breakdown"] = window["breakdown"]
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in verdict["checks"]}
    sys.stderr.flush()
    for name, v, lim in verdict["checks"]:
        print(f"check {name} = {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
