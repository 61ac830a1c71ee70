"""The reference's own lint, determinism and thread-safety tests, run on
both packages and compared.

Each case of tests/test_lint.py, test_lint_native.py, test_determinism.py
and test_thread_safety.py runs on ``stellar_core_tpu`` and again, compiled
against it, on ``stellar_core_tpu_torch`` (test_torch_mirror.py): the
outcomes must be equal.  The rewrite points the fixtures' path strings at
the port too, so a fixture written at "stellar_core_tpu/scp/mod.py" lands
in the port's consensus scope, and bench.py's clock exemption is checked
on chip_smoke.py, the port's timing driver.

WHOLE_TREE: two whole-tree gates cannot be mirrored as they stand.
Rewritten, test_lint.py's gate would hold the port's tree against the
reference's root LINT_BASELINE.json, whose keys name the reference's files
and bench.py, and test_determinism.py's would lint chip_smoke.py as the
reference's bench.py.  tests/test_torch_lint.py holds the port's tree to
the port's own baseline and to the four determinism rules instead.
test_lint_native.py's gate names only native/, which both packages lint,
so it is mirrored as it is (and test_torch_lint.py repeats it through the
port's default targets).

The scope cases below are the fault a plain copy of lint/ would have: the
reference's rules name the reference's paths and so stay silent on the
port's consensus code.
"""

from __future__ import annotations

import textwrap

import pytest

from test_torch_fleet_mirror import every_case
from test_torch_mirror import assert_mirrored, cases

FILES = ("test_lint.py", "test_lint_native.py", "test_determinism.py",
         "test_thread_safety.py")
WHOLE_TREE = {
    ("test_lint.py", "TestWholeTree.test_tree_is_clean_and_matches_baseline"),
    ("test_determinism.py",
     "TestWholeTreeDeterminism.test_tree_clean_under_the_four_rules"),
}
CASES = [(f, c) for f in FILES for c in cases(f) if (f, c) not in WHOLE_TREE]


@pytest.mark.parametrize("filename, case", CASES,
                         ids=[f"{f[:-3]}::{c}" for f, c in CASES])
def test_reference_lint_tests_on_both_packages(filename, case):
    assert_mirrored(filename, case)


def test_every_case_runs_but_the_whole_tree_gates():
    """cases() keeps every test of the four files that is not marked slow;
    only the WHOLE_TREE gates are left out."""
    for f in FILES:
        assert sorted(cases(f)) == sorted(every_case(f))
    assert WHOLE_TREE <= {(f, c) for f in FILES for c in cases(f)}
    assert len(CASES) == sum(len(cases(f)) for f in FILES) - len(WHOLE_TREE)


# -- the retargeted scopes ---------------------------------------------------

# test_determinism.py's own firing fixture: a set iterated into an
# escaping list of XDR frames
UNSORTED_BROADCAST = """
    def frames(items):
        out = []
        for x in set(items):
            out.append(x.to_xdr())
        return out
    """


def _hits(pkg: str, tmp_path, relpath: str, src: str, rule: str) -> int:
    lint = pytest.importorskip(f"{pkg}.lint")
    p = tmp_path / relpath
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    rep = lint.run_paths([str(tmp_path)], lint.rules_by_id([rule]),
                         root=str(tmp_path))
    return sum(v.rule == rule for v in rep.violations)


@pytest.mark.parametrize("scope", ["scp", "herder", "ledger", "soroban",
                                   "transactions", "bucket", "xdr"])
def test_consensus_scope_fixture_fires_in_the_port_only_under_the_port(
        tmp_path, scope):
    """A set iterated into a broadcast under the port's consensus scope
    fires the port's iteration-order rule; the same fixture under the
    reference's directory does not (that is the reference's scope), and
    the reference's rule is silent on the port's directory."""
    port_path = f"stellar_core_tpu_torch/{scope}/mod.py"
    ref_path = f"stellar_core_tpu/{scope}/mod.py"
    assert _hits("stellar_core_tpu_torch", tmp_path / "a", port_path,
                 UNSORTED_BROADCAST, "iteration-order") == 1
    assert _hits("stellar_core_tpu_torch", tmp_path / "b", ref_path,
                 UNSORTED_BROADCAST, "iteration-order") == 0
    assert _hits("stellar_core_tpu", tmp_path / "c", port_path,
                 UNSORTED_BROADCAST, "iteration-order") == 0
    assert _hits("stellar_core_tpu", tmp_path / "d", ref_path,
                 UNSORTED_BROADCAST, "iteration-order") == 1


@pytest.mark.parametrize("relpath, src, rule", [
    # rng-discipline's extra scope: the simulation layer
    ("{pkg}/simulation/mod.py",
     "import random\nx = random.random()\n", "rng-discipline"),
    # clock-discipline's allowed files: the port's clock and perf shim
    ("{pkg}/util/clock.py", "import time\nt = time.time()\n",
     "clock-discipline"),
    ("{pkg}/util/perf.py", "import time\nt = time.time()\n",
     "clock-discipline"),
    # eventlog-partitions' exempt file
    ("{pkg}/util/eventlog.py",
     "from x.util import eventlog\neventlog.record('NoSuch', 'INFO', 'm')\n",
     "eventlog-partitions"),
    # metric-registry's exempt files
    ("{pkg}/util/metrics.py", "registry().counter('Bad Name')\n",
     "metric-registry"),
    # decode-free-seam's whole-module scope
    ("{pkg}/ledger/native_apply.py",
     "def f(b):\n    return BucketEntry.from_xdr(b)\n", "decode-free-seam"),
])
def test_each_retargeted_path_names_the_port(tmp_path, relpath, src, rule):
    """Each path literal of the port's rules is the port's: the finding's
    presence flips between the two packages' directories exactly as it
    does between the reference's directory and an unrelated one."""
    def hits(pkg_dir, sub):
        return _hits("stellar_core_tpu_torch", tmp_path / sub,
                     relpath.format(pkg=pkg_dir), src, rule)

    port, other = hits("stellar_core_tpu_torch", "a"), hits("elsewhere", "b")
    ref_port = _hits("stellar_core_tpu", tmp_path / "c",
                     relpath.format(pkg="stellar_core_tpu"), src, rule)
    ref_other = _hits("stellar_core_tpu", tmp_path / "d",
                      relpath.format(pkg="elsewhere"), src, rule)
    assert ref_port != ref_other
    assert (port, other) == (ref_port, ref_other)


def test_chip_smoke_takes_bench_pys_clock_exemption(tmp_path):
    src = "import time\nt = time.time()\n"
    assert _hits("stellar_core_tpu_torch", tmp_path / "a", "chip_smoke.py",
                 src, "clock-discipline") == 0
    assert _hits("stellar_core_tpu_torch", tmp_path / "b", "bench.py",
                 src, "clock-discipline") == 1
    assert _hits("stellar_core_tpu", tmp_path / "c", "bench.py",
                 src, "clock-discipline") == 0
