"""The port's corelint, its sanitizer and warning half of _native_build,
and its hash-seed differential, on the port's own tree.

* The whole-tree gates the mirror leaves out (test_torch_lint_mirror.py,
  WHOLE_TREE), in the port's form: the port, chip_smoke.py and native/
  clean under every rule, the four determinism rules included, and equal
  to the port's own baseline
  (stellar_core_tpu_torch/lint/LINT_BASELINE.json), run as the command
  line a user runs, from the repo root; and native/ clean under the C
  rules with the reference's C suppressions.
* The port's baseline keys are the reference's own suppressions, at most
  as many, plus the reasoned ones listed in EXTRA.
* The verifier's locks are traced locks, in the order the runtime tracer
  records.
* _native_build's second half: the warning gate compiles what the
  reference's compiles, the sanitized libraries have their own
  directory, and the command line answers as the reference's.
* hashseed_diff: the children's payloads are the reference's, its
  children arm the port's detguard and need no jax, and its command line
  prints the reference's lines.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke
from stellar_core_tpu_torch import _native_build as nb
from stellar_core_tpu_torch.lint import (DEFAULT_TARGETS, rules_by_id,
                                         run_paths)
from stellar_core_tpu_torch.simulation import hashseed_diff

ROOT = Path(__file__).resolve().parent.parent
BASELINE = "stellar_core_tpu_torch/lint/LINT_BASELINE.json"
DET_RULES = list(chip_smoke.DET_RULES)
C_RULES = ["reader-discipline", "memcpy-provenance", "unchecked-alloc",
           "handler-result-discipline", "overlay-pairing"]
# suppressions of the port that the reference's tree has no counterpart
# of, each with the reason at its site
EXTRA = {
    # _node_client's thread and the determinism phase's differential
    # thread hand every failure to the main thread, which re-raises it
    "chip_smoke.py:exception-hygiene": 2,
}


def lint_cli(*args) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-m", "stellar_core_tpu_torch.lint", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def counts(doc: dict) -> dict:
    out = {}
    for s in doc["suppressed"]:
        key = f"{s['path']}:{s['rule']}"
        out[key] = out.get(key, 0) + 1
    return out


# -- the whole-tree gates, in the port's form --------------------------------

def test_port_tree_is_clean_and_equals_its_baseline():
    """`python -m stellar_core_tpu_torch.lint --baseline <port's>` from the
    repo root exits 0: no finding, no parse error, and every suppression
    key at the count the baseline holds (the ratchet is two-way)."""
    r = lint_cli("--baseline", BASELINE, "--json")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr
    doc = json.loads(r.stdout)
    assert doc["violations"] == [] and doc["parse_errors"] == []
    assert doc["files_scanned"] > 150
    baseline = json.loads((ROOT / BASELINE).read_text())["suppressions"]
    assert counts(doc) == baseline
    # the default targets: the port, chip_smoke.py, the shared C sources
    assert DEFAULT_TARGETS == ("stellar_core_tpu_torch", "chip_smoke.py",
                               "native")
    paths = {s["path"].split("/")[0] for s in doc["suppressed"]}
    assert paths == {"stellar_core_tpu_torch", "chip_smoke.py", "native"}
    # `make determinism` step 1 on the port (the four rules judge each
    # file alone, so the full run's findings are theirs): clean, and their
    # reasoned suppressions are the reference's kinds (every rng site was
    # fixable outright), found in the port's consensus scope
    det = [s for s in doc["suppressed"] if s["rule"] in DET_RULES]
    assert {s["rule"] for s in det} == set(DET_RULES) - {"rng-discipline"}
    assert any(s["path"].startswith("stellar_core_tpu_torch/herder/")
               for s in det)


def test_native_tree_is_clean_with_the_references_c_suppressions():
    rep = run_paths([str(ROOT / "native")], rules_by_id(C_RULES),
                    root=str(ROOT))
    assert rep.files_scanned >= 3
    assert rep.violations == [] and not rep.parse_errors
    c = rep.suppression_counts()
    assert c == {"native/capply.c:reader-discipline": 4,
                 "native/capply.c:memcpy-provenance": 1}


def test_baseline_is_the_references_suppressions_and_the_reasoned_extras():
    port = json.loads((ROOT / BASELINE).read_text())["suppressions"]
    ref = json.loads((ROOT / "LINT_BASELINE.json").read_text())[
        "suppressions"]
    mapped = {k.replace("stellar_core_tpu/", "stellar_core_tpu_torch/", 1):
              v for k, v in ref.items()}
    for key, n in port.items():
        if key in EXTRA:
            assert n == EXTRA[key], key
        else:
            assert key in mapped and n <= mapped[key], key
    assert not any(k.startswith("stellar_core_tpu/") or "bench.py" in k
                   for k in port)


def test_the_cli_refuses_a_baseline_with_a_partial_scope():
    r = lint_cli("--rules", "clock-discipline", "--baseline", BASELINE)
    assert r.returncode == 2 and "full scope" in r.stderr


# -- the repairs: traced locks, the frame's owner -----------------------------

def test_the_verifiers_locks_are_made_by_make_lock(monkeypatch):
    from stellar_core_tpu_torch.accel import ed25519
    from stellar_core_tpu_torch.util import lockorder, metrics
    src = Path(ed25519.__file__).read_text()
    assert "threading.Lock()" not in src and "import threading" not in src
    assert '_verifiers_lock = make_lock("accel.ed25519.verifiers")' in src
    rep = run_paths([ed25519.__file__], rules_by_id(["raw-lock"]),
                    root=str(ROOT))
    assert rep.violations == []
    monkeypatch.setattr(lockorder, "_enabled", True)
    # a registry of this test's own, its locks made while tracing is on
    monkeypatch.setattr(metrics, "_registry", metrics.MetricsRegistry())
    lockorder.reset_observed()
    try:
        v = ed25519.Ed25519BatchVerifier(64, device="cpu")
        assert type(v._lock).__name__ == "_TracedLock"
        assert v._lock.name == "accel.ed25519.verifier"
        sk = chip_smoke.SecretKey(b"\x07" * 32)
        msg = b"traced"
        got = v.verify([sk.public_key.ed25519], [sk.sign(msg)], [msg])
        assert list(got) == [True]
        # under the verifier's lock only the metrics' locks are taken, and
        # it is never taken under another
        edges = lockorder.observed_edges()
        assert set(edges) == {"accel.ed25519.verifier"}
        assert edges["accel.ed25519.verifier"] \
            <= {"metrics.registry", "metrics.histogram", "metrics.counter"}
    finally:
        lockorder.reset_observed()


def test_the_frame_hash_names_its_owner():
    from stellar_core_tpu_torch.transactions import frame
    src = Path(frame.__file__).read_text()
    assert re.search(r"if self\._hash is None:  # corelint: owned-by=main "
                     r"-- \S", src)
    ref = (ROOT / "stellar_core_tpu/transactions/frame.py").read_text()
    assert "owned-by" not in ref.split("def content_hash")[1][:400]


# -- _native_build's second half ---------------------------------------------

def test_every_reference_name_is_in_the_ports_native_build():
    import ast
    def names(path):
        tree = ast.parse(Path(path).read_text())
        out = set()
        for n in tree.body:
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
                out.add(n.name)
            elif isinstance(n, ast.Assign):
                out |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        return out
    ref = names(ROOT / "stellar_core_tpu/_native_build.py")
    assert ref <= names(nb.__file__)


def test_warn_check_compiles_what_the_references_compiles(monkeypatch):
    """The same compiler, flags and sources, and the same verdicts on the
    same compiler results."""
    from stellar_core_tpu import _native_build as ref_nb
    seen = {}

    def fake(tag):
        def run(cmd, **kw):
            seen.setdefault(tag, []).append(cmd)
            bad = cmd[-1].endswith("capply.c")
            return subprocess.CompletedProcess(
                cmd, 1 if bad else 0, "", "w: x [-Werror=y]" if bad else "")
        return run

    monkeypatch.setenv("CC", "cc")
    monkeypatch.setattr(nb.subprocess, "run", fake("port"))
    port = nb.warn_check()
    monkeypatch.setattr(ref_nb.subprocess, "run", fake("ref"))
    ref = ref_nb.warn_check()
    assert (port[0], sorted(port[1])) == (ref[0], sorted(ref[1]))
    assert port[0] is False and port[1][0] == "native/cxdr.c: warning-clean"
    assert sorted(seen["port"]) == sorted(seen["ref"])
    assert all("-Werror" in c and "-Wall" in c and "-Wextra" in c
               for c in seen["port"])


def test_warn_check_without_a_compiler_is_ok_with_a_notice(monkeypatch):
    monkeypatch.setattr(nb, "_cc", lambda: None)
    assert nb.warn_check() == (
        True, ["warn-check skipped: no C compiler on PATH"])
    assert not nb.sanitizer_available()
    monkeypatch.setattr(nb, "_stale_sanitized", lambda: ["_cxdr"])
    assert nb.ensure_sanitized() is False


def test_warn_check_on_this_compiler():
    """A real compile of every source: cxdr.c and cquorum.c are
    warning-clean, and capply.c is too or fails only on the
    -Warray-parameter mismatches the determinism phase knows of."""
    ok, details = nb.warn_check()
    verdict = chip_smoke.warn_check_verdict("\n".join(details))
    assert verdict["verdicts"]["native/cxdr.c"] == "warning-clean"
    assert verdict["verdicts"]["native/cquorum.c"] == "warning-clean"
    assert ok or verdict["only_known_fault"], details


def test_the_sanitized_build_has_its_own_directory():
    assert Path(nb._ASAN_DIR) == nb.BUILD_DIR / "asan"
    assert not nb._ASAN_DIR.startswith(nb._PKG)
    for mod in nb.EXTENSIONS:
        assert Path(nb._sanitized_path(mod)).parent == Path(nb._ASAN_DIR)
        assert nb.library_path(mod).parent == nb.BUILD_DIR
    env = nb.sanitizer_env({"LD_PRELOAD": "libx.so"})
    assert env["STPU_NATIVE_SANITIZE"] == "1"
    assert env["ASAN_OPTIONS"] == nb._ASAN_OPTIONS
    assert env["LD_PRELOAD"].endswith("libx.so")


def test_activation_after_a_load_is_refused(monkeypatch):
    monkeypatch.setitem(sys.modules, "stellar_core_tpu_torch._cxdr",
                        object())
    monkeypatch.setattr(nb, "ensure_sanitized",
                        lambda quiet=True: pytest.fail("built anyway"))
    with pytest.raises(RuntimeError, match="already loaded"):
        nb.activate_sanitized()
    assert nb._sanitized is False


def test_require_fresh(monkeypatch, tmp_path):
    with pytest.raises(ValueError):
        nb.require_fresh("_nope")
    monkeypatch.setattr(nb, "library_path", lambda mod: tmp_path / "x.so")
    assert nb.require_fresh("_capply") is False     # nothing built
    (tmp_path / "x.so").write_bytes(b"")
    monkeypatch.setattr(nb, "stale", lambda mod: False)
    assert nb.require_fresh("_capply") is True
    monkeypatch.setattr(nb, "stale", lambda mod: True)
    monkeypatch.setattr(nb, "ensure_native", lambda quiet=True: False)
    with pytest.raises(nb.StaleNativeExtensionError, match="_capply"):
        nb.require_fresh("_capply")


@pytest.mark.parametrize("argv, rc, said", [
    ([], 2, "--warn-check"),
    (["--asan-exec"], 2, "needs a command"),
    (["--bogus"], 2, "unknown mode"),
])
def test_native_build_cli_usage(argv, rc, said):
    r = subprocess.run([sys.executable, "-m",
                        "stellar_core_tpu_torch._native_build", *argv],
                       cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert r.returncode == rc and said in r.stderr


# -- hashseed_diff -------------------------------------------------------------

def test_the_childrens_payloads_are_the_references():
    from stellar_core_tpu.simulation import hashseed_diff as ref
    port = hashseed_diff._campaign_payload("soroban", 17, 3)
    assert port == ref._campaign_payload("soroban", 17, 3)
    assert port["passed"] and len(port["bucket_hashes"]) == 3


def test_the_children_run_the_port_with_the_guard_armed(monkeypatch):
    seen = {}

    class Popen:
        def __init__(self, argv, cwd, env, **kw):
            seen.update(argv=argv, env=env, cwd=cwd)

    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(hashseed_diff.subprocess, "Popen", Popen)
    hashseed_diff._spawn("soroban", 424242, 17, 4, "out.json")
    assert seen["argv"][1:4] == [
        "-m", "stellar_core_tpu_torch.simulation.hashseed_diff", "--child"]
    assert seen["env"]["PYTHONHASHSEED"] == "424242"
    assert seen["env"]["STPU_DETGUARD"] == "1"
    assert "JAX_PLATFORMS" not in seen["env"]
    assert seen["cwd"] == str(ROOT)


def test_the_cli_prints_the_references_lines():
    """Both packages' `--campaign soroban --ledgers 4`: IDENTICAL, regions
    in both children and no trip, in the same words."""
    def line(pkg):
        r = subprocess.run(
            [sys.executable, "-m", f"{pkg}.simulation.hashseed_diff",
             "--campaign", "soroban", "--ledgers", "4"],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert r.returncode == 0, r.stdout + r.stderr
        return re.sub(r"wall=[\d.]+s", "wall=*", r.stdout)

    port = line("stellar_core_tpu_torch")
    assert port == line("stellar_core_tpu")
    m = re.fullmatch(r"hashseed-diff \[soroban\] seeds=\[0, 424242\] "
                     r"IDENTICAL wall=\* regions=\[(\d+), (\d+)\] "
                     r"trips=\[0, 0\]\n", port)
    assert m and int(m.group(1)) > 0 and int(m.group(2)) > 0


def test_the_report_keeps_each_childs_wall_time_and_verifies():
    rep = hashseed_diff.run_pair("soroban", ledgers=2, timeout_s=300.0)
    assert rep["ok"] and rep["identical"] and rep["divergence"] is None
    assert [c["seed"] for c in rep["children"]] == [0, 424242]
    for c in rep["children"]:
        assert c["wall_s"] > 0 and isinstance(c["verify_recompute"], int)
