"""host.gc_full_passes.catchup reads the window delta of the program's
`process.gc-full` counter, 0 included, and None from a program without
the counter; it is a catchup-pubnet entry of BENCHMARK.json."""

import gc

from portbench.lib import harness

NAME = "host.gc_full_passes.catchup"


def test_reads_the_window_delta_of_full_passes():
    read = harness.metric_reader(NAME)
    before = harness.registry_snapshot()
    gc.collect()
    gc.collect()
    delta = harness.registry_delta(before, harness.registry_snapshot())
    assert read(harness.Context(delta, None, {})) >= 2
    assert read(harness.Context({"process.gc-full": 0}, None, {})) == 0


def test_reads_none_from_a_program_without_the_counter():
    read = harness.metric_reader(NAME)
    assert read(harness.Context({"process.gc-pause": (3, 0.1)}, None,
                                {})) is None


def test_is_a_catchup_pubnet_entry():
    bench = harness.load_benchmark()
    [entry] = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert entry["workloads"] == ["catchup-pubnet"]
    assert entry["moves"] == "replay_ledgers_per_s"
    assert NAME in {m["name"] for m in
                    harness.find_cell(bench, "catchup-pubnet")["per_layer"]}
