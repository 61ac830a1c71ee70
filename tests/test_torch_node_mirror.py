"""The reference's own overlay, network and application tests, run on both
packages and compared.

Each case of tests/test_overlay.py, test_herder_simulation.py,
test_anomaly.py, test_slo.py, test_sampleprof.py and test_main.py runs on
``stellar_core_tpu`` and again, compiled against it, on
``stellar_core_tpu_torch`` (test_torch_mirror.py): the outcomes must be
equal and every ledger close the same hash and result set, byte for byte.
The reference's nodes run with its default ACCEL, "none"; the port's
default is the card, so its nodes are given "none" too (``STPU_ACCEL``,
which also reaches the command line the tests start as subprocesses).

Where a case's ledgers depend on time it measures, the closes are held
equal as far as both runs went (TIMED: an anomaly flagged on measured
close latency ends the run a few ledgers earlier or later), and where
they are taken on the wall clock, without their hashes (WALL_CLOCK: three
nodes over TCP on a REAL_TIME clock, whose close times are the seconds
the run took).

Left out by name, so that no case is left out silently: REFUSED, a
config that asks for ACCEL = "tpu", which the port refuses (held apart
below).  AWAITING_COMMANDS is empty: every subcommand of the reference
is ported, and COMMAND_CASES, the cases that waited for them and
TestFuzzers' (which waited for fuzz.py), all run.  test_main.py's
three-process network is marked slow and stays out of tier 1, as it does
for the reference.
"""

from __future__ import annotations

import pytest
import torch

from test_torch_mirror import PORT, REF, assert_mirrored, cases, run_case

FILES = ("test_overlay.py", "test_herder_simulation.py", "test_anomaly.py",
         "test_slo.py", "test_sampleprof.py", "test_main.py")
# the cases of the 24 subcommands that waited for their port: none now
AWAITING_COMMANDS = set()
# the cases that waited for them, and TestFuzzers (which waited for fuzz.py)
COMMAND_CASES = {
    ("test_main.py", "TestCli.test_version"),
    ("test_main.py", "TestCli.test_gen_seed_and_sec_to_pub"),
    ("test_main.py", "TestCli.test_diag_bucket_stats"),
    ("test_main.py", "TestNewCliCommands.test_encode_asset_and_convert_id"),
    ("test_main.py",
     "TestNewCliCommands.test_print_xdr_and_sign_transaction"),
    ("test_main.py", "TestNewCliCommands.test_fuzz_cli_xdr_mode"),
    ("test_main.py", "TestNewCliCommands.test_gen_fuzz_writes_corpus"),
    ("test_main.py", "TestNewCliCommands.test_apply_load_cli"),
    ("test_main.py",
     "TestHealthProbePolling.test_unreachable_without_retries_exits_1"),
    ("test_main.py",
     "TestHealthProbePolling.test_retries_poll_until_the_endpoint_comes_up"),
    ("test_main.py", "TestFuzzers.test_xdr_roundtrip_fuzz"),
    ("test_main.py", "TestFuzzers.test_transaction_fuzzer"),
    ("test_main.py", "TestFuzzers.test_overlay_fuzzer"),
}
REFUSED = {("test_main.py", "TestConfig.test_toml_parsing")}
TIMED = {("test_anomaly.py",
          "TestRegressionProof.test_injected_close_regression_flags_and_clears")}
WALL_CLOCK = {
    ("test_overlay.py",
     "TestOverTCP.test_three_node_network_closes_ledgers_over_tcp"),
    ("test_overlay.py",
     "TestBatchedTransportOverTCP.test_mixed_mode_fleet_interoperates"),
}
# the application cases this slice ports (they must stay in the mirror)
APPLICATION = {
    "TestCli.test_new_db_creates_genesis",
    "TestStandaloneApp.test_standalone_node_closes_ledgers_in_process",
    "TestNodeAdminSurface.test_self_check_and_maintenance",
    "TestNodeAdminSurface.test_manual_close_and_ledger_entry",
    "TestNodeAdminSurface.test_upgrades_endpoint_backend",
    "TestInPlaceArchiveCatchup.test_out_of_sync_node_catches_up_from_archive",
}


@pytest.fixture(autouse=True)
def accel_off_on_one_thread(monkeypatch):
    monkeypatch.setenv("STPU_ACCEL", "none")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_mirrored_as_far_as_both_went(filename: str, case: str,
                                        hashes: bool = True) -> None:
    """The outcomes equal, and each ledger both runs closed the same
    (seq, result set), with the same hash where `hashes`."""
    ref = run_case(filename, case, REF)
    assert all(o[0] != "fail" for o in ref["outcomes"]), ref["outcomes"]
    port = run_case(filename, case, PORT)
    assert port["outcomes"] == ref["outcomes"]

    def closes(run):
        out = {}
        for c in run["closes"]:
            assert c[0] != "raise", c
            out.setdefault(c[0], set()).add(c if hashes else (c[0], c[2]))
        return out

    a, b = closes(port), closes(ref)
    assert a and b
    for seq in sorted(a.keys() & b.keys()):
        assert a[seq] == b[seq], f"ledger {seq} of {case}"


@pytest.mark.parametrize("filename, case", [
    (f, c) for f in FILES for c in cases(f)
    if (f, c) not in AWAITING_COMMANDS | REFUSED])
def test_reference_node_tests_on_both_packages(filename, case):
    if (filename, case) in TIMED | WALL_CLOCK:
        assert_mirrored_as_far_as_both_went(
            filename, case, hashes=(filename, case) not in WALL_CLOCK)
    else:
        assert_mirrored(filename, case)


def test_a_config_asking_for_the_tpu_is_refused():
    """The reference's config test passes with ACCEL = "tpu"; the port
    refuses that value where it reads the config."""
    (f, c), = REFUSED
    assert run_case(f, c, REF)["outcomes"] == [("ok",)]
    (outcome,) = run_case(f, c, PORT)["outcomes"]
    assert outcome[:2] == ("fail", "ValueError") and "'tpu'" in outcome[2]


def test_every_case_runs_but_those_named():
    """cases() keeps every test of the files that is not marked slow and
    names no module the port lacks; the named sets hold only cases the
    files have, and the application cases are all mirrored."""
    for f, c in AWAITING_COMMANDS | REFUSED | TIMED | WALL_CLOCK:
        assert c in cases(f), (f, c)
    assert APPLICATION <= set(cases("test_main.py"))
    assert not APPLICATION & {c for _, c in AWAITING_COMMANDS | REFUSED}
    assert {c for _, c in COMMAND_CASES} <= set(cases("test_main.py"))
    for f in FILES:
        import ast
        from test_torch_mirror import TESTS, _marks
        tree = ast.parse((TESTS / f).read_text())
        every = [n.name for n in tree.body
                 if isinstance(n, ast.FunctionDef)
                 and n.name.startswith("test_") and "slow" not in _marks(n)]
        for node in tree.body:
            if isinstance(node, ast.ClassDef) \
                    and node.name.startswith("Test") \
                    and "slow" not in _marks(node):
                every += [f"{node.name}.{fn.name}" for fn in node.body
                          if isinstance(fn, ast.FunctionDef)
                          and fn.name.startswith("test_")
                          and "slow" not in _marks(fn)]
        assert sorted(every) == sorted(cases(f)), f
    assert not AWAITING_COMMANDS
