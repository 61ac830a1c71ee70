"""One short run of each cell through run.py on the card: the result line
has the contract's keys and reads correct."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent


@pytest.mark.card
@pytest.mark.parametrize("workload", ["catchup-pubnet", "tx-steady"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(card, workload, trace):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if workload not in {w["name"] for w in bench["workloads"]}:
        pytest.skip(f"{workload} is not a cell of BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 17), "--seconds", "10", "--trace",
         str(trace)], capture_output=True, text=True, cwd=str(ROOT),
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == card
    if trace:
        assert line["device"]["busy_s"] > 0
