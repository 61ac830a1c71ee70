"""What every cell shares: finding a cell's files by the names in
BENCHMARK.json, the port's counters and timers read over a window, the
per-layer metric readers, the forbidden-module check and the result line.

A cell is a configuration (configs/<config>.json, whose "runner" names the
module runners/<runner>.py that runs it), a traffic mix
(mixes/<traffic>.json) and the per-layer metrics whose reader is
metrics/<name>.py, a module with read(ctx) that returns the metric's value
or None where it finds nothing to read.  Adding a cell, a configuration, a
mix or a metric adds files and BENCHMARK.json entries and edits none."""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "stellar_core_tpu")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The workload `name` with its configuration, mix, end-to-end and
    per-layer metric entries."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(bench_dir.parent / cfg_entry["file"]) as f:
        cfg = json.load(f)
    with open(bench_dir / "mixes" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return {"workload": w, "config": cfg, "mix": mix, "end_to_end": e2e,
            "per_layer": layer}


def runner(cfg: dict):
    return importlib.import_module(f"portbench.runners.{cfg['runner']}")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The read function of metrics/<name>.py."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def registry_snapshot() -> dict:
    """{name: value} of the port's counters and {name: (count, sum)} of
    its timers (stellar_core_tpu_torch.util.metrics)."""
    from stellar_core_tpu_torch.util import metrics
    out = {}
    for name, m in metrics.registry().items():
        if isinstance(m, metrics.Counter):
            out[name] = m.value
        elif isinstance(m, metrics.Timer):
            out[name] = (m.count, m.total)
    return out


def registry_delta(before: dict, after: dict) -> dict:
    out = {}
    for name, v in after.items():
        b = before.get(name)
        if isinstance(v, tuple):
            b = b or (0, 0.0)
            out[name] = (v[0] - b[0], v[1] - b[1])
        else:
            out[name] = v - (b or 0)
    return out


class Context:
    """What a per-layer reader reads: `registry`, the window deltas of the
    port's counters ({name: n}) and timers ({name: (count, seconds)});
    `trace`, the window's lib.trace.DeviceTrace (None untraced); `stats`,
    the runner's own counts of the window."""

    def __init__(self, registry: dict, trace, stats: dict):
        self.registry, self.trace, self.stats = registry, trace, stats

    def counter(self, name: str) -> int:
        return self.registry.get(name, 0)

    def timer(self, name: str) -> tuple:
        return self.registry.get(name, (0, 0.0))


def read_metrics(entries: list, ctx: Context) -> dict:
    out = {}
    for m in entries:
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)
