"""The harness's arithmetic and its refusals, on the CPU."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.runners.validator import p95
from portbench.lib import harness, peaks, readers
from portbench.lib import trace as tr

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def test_union_and_gaps():
    ops = [("k", 0, 10), ("k", 5, 20), ("c", 30, 40), ("k", 35, 36)]
    assert tr.union_s(ops) == pytest.approx(30e-9)
    assert tr.op_seconds(ops) == [["k", 26e-9], ["c", 10e-9]]
    # a gap is split where the host's spans begin and end
    gaps = tr.idle_gaps(ops, 0, 100, [(25, 28, "a"), (45, 80, "b")], "o")
    assert gaps == [["b", 35e-9], ["o", 32e-9], ["a", 3e-9]]


def test_innermost_spans_take_the_gap():
    # a close inside a checkpoint apply, inside a window with a bucket
    # apply before it: each interval keeps what no inner span covers
    levels = [[(30, 40, "close"), (50, 60, "close")],
              [(20, 70, "apply")],
              [(0, 10, "buckets")]]
    assert tr.innermost(levels) == [
        (0, 10, "buckets"), (20, 30, "apply"), (30, 40, "close"),
        (40, 50, "apply"), (50, 60, "close"), (60, 70, "apply")]
    gaps = tr.idle_gaps([], 0, 100, tr.innermost(levels), "o")
    assert gaps == [["o", 40e-9], ["apply", 30e-9], ["close", 20e-9],
                    ["buckets", 10e-9]]


class _Trace:
    def __init__(self, ops, window_s):
        self.ops, self.window_s = ops, window_s


def test_readers():
    ops = [("verify_generic_kernel(x)", 0, 1_000_000),
           ("Memcpy HtoD", 1_000_000, 1_500_000)]
    ctx = harness.Context({"accel.ed25519.generic-sigs": 2048,
                           "ledger.ledger.close": (4, 2.0)},
                          _Trace(ops, 0.01), {})
    assert readers.close_ms(ctx) == pytest.approx(500.0)
    assert readers.idle_pct(ctx) == pytest.approx(85.0)
    want = 100 * 2048 * peaks.SIG_PRODUCTS / peaks.PEAK_MULADDS_PER_S / 1e-3
    assert readers.verify_roofline_pct(ctx) == pytest.approx(want)
    empty = harness.Context({}, None, {})
    for read in (readers.close_ms, readers.idle_pct,
                 readers.verify_roofline_pct):
        assert read(empty) is None


def test_peak_and_least_time():
    assert peaks.PEAK_MULADDS_PER_S == pytest.approx(1.6727e13, rel=1e-4)
    # one 2,048-signature K-G launch takes about 0.395 ms on the card
    assert peaks.least_verify_s(2048) == pytest.approx(1.4406e-5, rel=1e-3)


def test_p95_nearest_rank():
    assert p95(list(range(1, 101))) == 95
    assert p95([3.0]) == 3.0


def test_every_metric_has_a_reader():
    bench = harness.load_benchmark()
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        assert cell["per_layer"] and cell["end_to_end"]
        assert "setup_s" in {m["name"] for m in cell["end_to_end"]}


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "catchup-pubnet",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0",
         *extra], capture_output=True, text=True, cwd=str(cwd), timeout=300)


def test_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(ROOT)
    assert out.returncode == 3 and out.stdout == "", out.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == "", out.stderr


def test_benchmark_json_names_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (BENCH / "mixes" / f"{w['traffic']}.json").is_file()
