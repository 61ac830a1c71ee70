"""The catchup-channels cell at a tiny size on the CPU, on both of the
port's apply paths (its Python close, and the native engine where it
loads): a 5 s window of whole passes closes, a sound run is correct, its
table metrics read, and each fault the cell can have makes it not
correct."""

import contextlib
import copy
import json

import pytest

from portbench.lib import faults, harness
from portbench.runners import catchup_channels

from . import tiny

PATHS = [pytest.param(False, id="python"), pytest.param(True, id="native")]


def _tiny_cell(native: bool = False) -> dict:
    # tiny.cell cuts only the configurations whose runner is `catchup`
    bench = json.loads((tiny.BENCH.parent / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, "catchup-channels")
    cfg = copy.deepcopy(cell["config"])
    cfg["archive"].update(accounts=200, services=2, channels_per_service=6,
                          txs_per_ledger=24, payment_ledgers=4,
                          corrupt_every=7)
    cfg["catchup"]["native"] = native
    return dict(cell, config=cfg)


@pytest.fixture(autouse=True)
def _plain_kernels(monkeypatch):
    from stellar_core_tpu_torch.catchup.catchup import PreverifyPipeline
    monkeypatch.setattr(PreverifyPipeline, "DEFAULT_DEVICE", "cpu")
    # each run starts from verifiers with no use counts and no tables, as
    # a new catchup process does: counts left by an earlier run would turn
    # the tiny archive's ordinary keys hot, and each would take a table
    # built by the plain K-B, which is slow on the CPU
    from stellar_core_tpu_torch.accel import ed25519
    monkeypatch.setattr(ed25519, "_verifiers", {})


def _run(tmp_path, native, fault=None, seconds=5.0):
    tiny.engine_or_skip(native)
    c = catchup_channels.Cell(_tiny_cell(native), 2 ** 31 + 77, seconds,
                              False, device="cpu",
                              workdir=tmp_path / "work")
    c.setup()
    with faults.plant(fault) if fault else contextlib.nullcontext():
        w = tiny.within(c.run)
    c.release()
    return c, w, c.check()


@pytest.mark.parametrize("native", PATHS)
def test_sound_run_is_correct_and_its_metrics_read(tmp_path, native):
    c, w, v = _run(tmp_path, native)
    assert v["correct"], v
    st = w["stats"]
    assert st["window_s"] >= 5.0
    assert st["ledgers_in_window"] == st["passes"] * (c.last - c.first + 1)
    assert w["end_to_end"]["replay_ledgers_per_s"] > 0
    assert st["native_checkpoints"] == (st["passes"] if native else 0)
    reg = w["registry"]
    assert reg["accel.ed25519.table-sigs"] > 0
    assert reg.get("crypto.verify.recompute", 0) == 0
    ctx = harness.Context(reg, None, st)
    layer = {m["name"]: m for m in _tiny_cell()["per_layer"]}
    got = harness.read_metrics(list(layer.values()), ctx)
    # untraced: the device metrics read None; the counters' read
    assert 0 < got["accel.table_sig_pct.channels"]["value"] < 100
    assert got["catchup.cpu_verify_pct.channels"]["value"] == 0
    assert "accel.hot_no_slot_pct.channels" in got
    for name in ("verify.prep_ms_per_ksig.channels",
                 "catchup.collect_wait_ms.channels",
                 "catchup.bucket_apply_ms.channels",
                 "catchup.apply_ms_per_ledger.channels"):
        assert got[name]["value"] > 0, name
    # the Python close's timer reads only where the Python path closes
    assert ("ledger.close_ms.channels" in got) is not native
    assert got["host.gc_full_passes.channels"]["value"] >= 0
    assert not {"kernel.tables_roofline_pct.channels",
                "kernel.generic_roofline_pct.channels",
                "host.gc_pause_pct.channels",
                "device.idle_pct.channels"} & set(got)


def test_a_program_without_the_new_counter_reads_none():
    ctx = harness.Context({"accel.ed25519.table-sigs": 10,
                           "accel.ed25519.generic-sigs": 10}, None, {})
    read = harness.metric_reader("accel.hot_no_slot_pct.channels")
    assert read(ctx) is None
    ctx.registry["accel.ed25519.hot-no-slot"] = 0
    assert read(ctx) == 0.0


def test_the_engines_own_verifies_count_as_the_cpus():
    read = harness.metric_reader("catchup.cpu_verify_pct.channels")
    ctx = harness.Context({"crypto.verify.recompute": 1,
                           "crypto.verify.cache-hit": 3}, None,
                          {"native_verify_cache_misses": 2,
                           "native_verify_cache_hits": 4})
    assert read(ctx) == 30.0
    assert read(harness.Context({}, None, {})) is None


@pytest.mark.parametrize("native", PATHS)
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_caught(tmp_path, native, fault):
    _, _, v = _run(tmp_path, native, fault)
    assert not v["correct"], v
