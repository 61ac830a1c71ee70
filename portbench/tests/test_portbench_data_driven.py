"""A later change adds a configuration, a mix and a per-layer metric as new
files and BENCHMARK.json entries, and edits no file that is there."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_config_mix_and_metric_are_new_files(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy)
    before = _digests(copy / "portbench")

    pb = copy / "portbench"
    cfg = json.loads((pb / "configs" / "catchup-pubnet.json").read_text())
    cfg["name"] = "catchup-small"
    cfg["archive"]["accounts"] = 2000
    (pb / "configs" / "catchup-small.json").write_text(json.dumps(cfg))
    (pb / "mixes" / "archive-replay-warm.json").write_text(
        json.dumps({"about": "a longer warm pass", "warm_ledgers": 2}))
    (pb / "metrics" / "catchup.passes.py").write_text(
        "def read(ctx):\n    return ctx.stats.get('passes')\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "catchup-small", "source": "https://example.org/x",
        "file": "portbench/configs/catchup-small.json",
        "reduced": ["accounts"], "why": "a smaller state"})
    bench["workloads"].append({
        "name": "catchup-small.warm", "config": "catchup-small",
        "traffic": "archive-replay-warm", "chips": 1, "why": "longer warm-up"})
    bench["per_layer"].append({
        "name": "catchup.passes", "unit": "passes", "better": "higher",
        "source": "host_clock", "layer": "catchup",
        "moves": "replay_ledgers_per_s",
        "workloads": ["catchup-small.warm"]})
    bench["end_to_end"][0]["workloads"].append("catchup-small.warm")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before
    probe = (
        "import sys, json; sys.path.insert(0, {c!r})\n"
        "from portbench.lib import harness\n"
        "cell = harness.find_cell(harness.load_benchmark(), "
        "'catchup-small.warm')\n"
        "read = harness.metric_reader('catchup.passes')\n"
        "ctx = harness.Context({{}}, None, {{'passes': 3}})\n"
        "print(json.dumps([cell['config']['archive']['accounts'], "
        "cell['mix']['warm_ledgers'], "
        "[m['name'] for m in cell['per_layer']], "
        "[m['name'] for m in cell['end_to_end']], read(ctx), "
        "harness.runner(cell['config']).__name__]))\n").format(c=str(copy))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, cwd=str(copy), timeout=120, check=True)
    accounts, warm, layer, e2e, passes, drv = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert (accounts, warm, passes) == (2000, 2, 3)
    assert layer == ["catchup.passes"]
    assert e2e == ["replay_ledgers_per_s", "setup_s"]
    assert drv == "portbench.runners.catchup"
