"""The port stands alone and never falls back.

* Importing every module of stellar_core_tpu_torch and chip_smoke leaves
  jax and stellar_core_tpu out of sys.modules (fresh subprocess), as does
  a range worker of a parallel catchup, spawned as the command line runs
  it.
* No ``import`` or ``from`` statement at any depth of any of those files
  names jax or stellar_core_tpu (an AST walk: a function-level import
  runs only when the function does, so the subprocess cannot see it).
* With no device argument and no CUDA, the entry points raise.
* The CUDA wrappers never run their plain version on a tensor that is not
  on the CPU, and a missing nvcc is an error, not a fallback.
"""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stellar_core_tpu_torch import _cuda_build, device, graft_entry, testutils
from stellar_core_tpu_torch.accel import ed25519, field, quorum, tables

ROOT = Path(__file__).resolve().parent.parent
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in (ROOT / "stellar_core_tpu_torch").rglob("*.py"))


# state and apply: the modules a ledger close runs, and their packages
STATE_AND_APPLY = {f"stellar_core_tpu_torch.{m}" for m in (
    "ledger", "ledger.ledger_txn", "ledger.costs", "ledger.manager",
    "ledger.native_apply", "ledger.native_close",
    "bucket", *(f"bucket.{b}" for b in ("bucket", "index", "future",
                                        "snapshot", "bucket_list",
                                        "manager")),
    *(f"transactions.{t}" for t in ("utils", "sponsorship",
                                    "offer_exchange", "operations",
                                    "offer_ops", "frame")),
    "soroban", *(f"soroban.{s}" for s in ("config", "host", "storage",
                                          "txset", "scheduler", "ops")),
    "invariant", "invariant.invariants", "herder.upgrades",
    "history", "history.archive", "database", "database.database",
    "testutils")}

# the catchup seam and its command line
CATCHUP = {f"stellar_core_tpu_torch.{m}" for m in (
    "__main__", "work", "work.work", "history.manager", "simulation",
    "simulation.loadgen", "catchup", "catchup.catchup", "catchup.parallel",
    "historywork", "historywork.works", "util.process", "accel.mesh",
    "main", "main.config", "main.commandline")}

# the live node's admission and consensus, and the quorum checker's host
# modules
LIVE_NODE = {f"stellar_core_tpu_torch.{m}" for m in (
    "scp", *(f"scp.{s}" for s in ("quorum", "driver", "local_node",
                                  "nomination", "ballot", "slot", "scp")),
    "herder", *(f"herder.{h}" for h in ("tx_queue", "admission",
                                        "pending_envelopes",
                                        "quorum_tracker", "herder",
                                        "quorum_intersection")))}

# the overlay and the application: the node `run` serves, in-process
# networks, and their helpers
NODE = {f"stellar_core_tpu_torch.{m}" for m in (
    "overlay", *(f"overlay.{o}" for o in ("ban", "peer_manager", "peer_auth",
                                          "flood", "peer", "overlay_manager",
                                          "survey", "tcp")),
    "crypto.box", "crypto.rfc7748",
    *(f"util.{u}" for u in ("timeseries", "anomaly", "slo", "sampleprof")),
    *(f"main.{m}" for m in ("status", "maintainer", "selfcheck",
                            "http_admin", "application")),
    "simulation.simulation")}

# the fleet, the chaos campaigns, the fuzzers, apply-load and the
# helpers of the remaining subcommands
FLEET = {f"stellar_core_tpu_torch.{m}" for m in (
    "fuzz", "simulation.fleet", "simulation.chaos", "simulation.apply_load",
    "util.fleettrace", "util.fs")}

# the last slice: corelint and the hash-seed differential
LINT = {f"stellar_core_tpu_torch.{m}" for m in (
    "lint", "lint.__main__", "lint.core", "lint.clex", "lint.rules",
    *(f"lint.rules.{r}" for r in ("clock", "decode_free", "determinism",
                                  "eventlog", "exceptions", "ledger_txn",
                                  "lock_order", "metric_names", "native_c",
                                  "thread_safety")),
    "simulation.hashseed_diff")}

FOUNDATIONS = {f"stellar_core_tpu_torch.{m}" for m in (
    "_native_build", "transactions.signature_checker",
    *(f"util.{u}" for u in ("scheduler", "clock", "lockorder", "cache",
                            "metrics", "assertions", "logging", "racetrace",
                            "tracing", "eventlog", "detguard", "perf")),
    *(f"crypto.{c}" for c in ("sha", "strkey", "sodium", "keys")),
    *(f"xdr.{x}" for x in ("codec", "types", "contract", "ledger_entries",
                           "transaction", "scp", "ledger", "overlay")))}


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    assert "stellar_core_tpu_torch.accel.ed25519" in PORT_MODULES
    assert {"stellar_core_tpu_torch.graft_entry",
            "stellar_core_tpu_torch.crypto.rfc8032",
            "stellar_core_tpu_torch.xdr", "stellar_core_tpu_torch.util",
            "stellar_core_tpu_torch.transactions"} | FOUNDATIONS \
        | STATE_AND_APPLY | CATCHUP | LIVE_NODE | NODE | FLEET | LINT \
        <= set(PORT_MODULES)
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'stellar_core_tpu' or m.startswith('stellar_core_tpu.'))\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


WORKER_PROBE = (
    "import runpy, sys\n"
    "sys.argv = ['stellar_core_tpu_torch'] + sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_module('stellar_core_tpu_torch', run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    rc = e.code\n"
    "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
    "             or m == 'stellar_core_tpu' or m.startswith('stellar_core_tpu.'))\n"
    "print('RC', rc, 'BAD', bad)\n")


LAST_SLICE_PROBE = (
    "import contextlib, io, runpy, sys\n"
    "out = io.StringIO()\n"
    "for mod, argv in (('stellar_core_tpu_torch.lint', ['--list-rules']),\n"
    "                  ('stellar_core_tpu_torch.lint',\n"
    "                   ['stellar_core_tpu_torch/lint', 'native']),\n"
    "                  ('stellar_core_tpu_torch._native_build', ['--bogus'])):\n"
    "    sys.argv = [mod] + argv\n"
    "    try:\n"
    "        with contextlib.redirect_stdout(out), \\\n"
    "                contextlib.redirect_stderr(out):\n"
    "            runpy.run_module(mod, run_name='__main__')\n"
    "    except SystemExit:\n"
    "        pass\n"
    "from stellar_core_tpu_torch.simulation import hashseed_diff as h\n"
    "p = h._campaign_payload('soroban', 17, 2)\n"
    "assert p['passed'], p\n"
    "assert 'iteration-order' in out.getvalue(), out.getvalue()\n"
    "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
    "             or m == 'stellar_core_tpu' or m.startswith('stellar_core_tpu.'))\n"
    "print(bad)\n")


def test_the_last_slice_runs_without_jax():
    """The new modules run, not only imported, in a fresh process: the
    lint command line (listing its rules, linting its own package and the
    C sources), _native_build's command line and a hash-seed campaign's
    child payload; neither jax nor the JAX package is then loaded."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", LAST_SLICE_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_spawned_range_worker_imports_no_jax(tmp_path):
    """`python -m stellar_core_tpu_torch catchup-range --accel cpu`, as
    the parallel catchup spawns it, on an archive the port published:
    it replays its range and has imported neither jax nor the JAX
    package."""
    from stellar_core_tpu_torch.history.archive import FileHistoryArchive
    from stellar_core_tpu_torch.history.manager import HistoryManager
    from stellar_core_tpu_torch.ledger.manager import LedgerManager
    from stellar_core_tpu_torch.simulation import LoadGenerator

    mgr = LedgerManager(testutils.network_id("isolated net"))
    mgr.start_new_ledger()
    history = HistoryManager(mgr, "isolated net", [FileHistoryArchive(
        str(tmp_path / "archive"))])
    gen = LoadGenerator(mgr, history, seed=3)
    gen.create_accounts(4, per_ledger=4)
    gen.payment_ledgers(2, txs_per_ledger=2)
    gen.run_to_checkpoint_boundary()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, "-c", WORKER_PROBE, "catchup-range",
         "--archive", str(tmp_path / "archive"),
         "--passphrase", "isolated net", "--to", "63",
         "--workdir", str(tmp_path / "w"),
         "--result", str(tmp_path / "result.json"), "--accel", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "RC 0 BAD []", out.stdout
    import json
    result = json.loads((tmp_path / "result.json").read_text())
    assert result["final_hash"] == mgr.lcl_hash.hex()


def _forbidden(name: str) -> bool:
    return any(name == root or name.startswith(root + ".")
               for root in ("jax", "stellar_core_tpu"))


def forbidden_imports(source: str, module: str):
    """(line, what) of each import, at any depth of `source`, of jax or of
    stellar_core_tpu (not stellar_core_tpu_torch), relative imports
    resolved against `module`'s package and import_module / __import__
    calls on a constant name included."""
    package = module.split(".")[:-1]
    found = []
    for node in ast.walk(ast.parse(source)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                if node.level - 1 > len(package) - 1:
                    found.append((node.lineno, "relative import past the "
                                  "package root"))
                    continue
                base = package[:len(package) - (node.level - 1)]
                names = [".".join(base + ([node.module] if node.module
                                          else []))]
            else:
                names = [node.module]
            names += [f"{names[0]}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and ((isinstance(node.func, ast.Attribute)
                      and node.func.attr == "import_module")
                     or (isinstance(node.func, ast.Name)
                         and node.func.id == "__import__")):
            names = [node.args[0].value]
        found += [(node.lineno, n) for n in names if _forbidden(n)]
    return found


def test_no_import_of_jax_or_the_jax_package_at_any_depth():
    files = sorted((ROOT / "stellar_core_tpu_torch").rglob("*.py"))
    assert len(files) == len(PORT_MODULES) > 40
    bad = {}
    for path in files + [ROOT / "chip_smoke.py"]:
        parts = path.relative_to(ROOT).with_suffix("").parts
        found = forbidden_imports(path.read_text(), ".".join(parts))
        if found:
            bad[str(path.relative_to(ROOT))] = found
    assert bad == {}


def port_imports(source: str, module: str):
    """(line, module, names) of each import, at any depth of `source`, of
    a module of the port: absolute ones and relative ones, resolved
    against `module`'s package (names: what a `from` statement takes from
    the module, else ())."""
    package = module.split(".")[:-1]
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name, ()) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[:len(package) - (node.level - 1)]
                name = ".".join(base + ([node.module] if node.module else []))
            else:
                name = node.module
            found.append((node.lineno, name,
                          tuple(a.name for a in node.names)))
    root = "stellar_core_tpu_torch"
    return [(line, name, names) for line, name, names in found
            if name == root or name.startswith(root + ".")]


def _module_file(name: str):
    """The port file or package of a dotted module name, or None."""
    base = ROOT.joinpath(*name.split("."))
    for path in (base.with_suffix(".py"), base / "__init__.py"):
        if path.exists():
            return path
    return None


# lazy imports of modules the port does not have yet, each where it may
# stand (none now: simulation.loadgen's AdmissionCampaign imported the
# admission pipeline before it was ported)
AWAITING = {}


def test_every_import_inside_the_port_resolves_in_the_port():
    """Each module a port file (or chip_smoke.py) imports, at any depth,
    is a module of the port; each name a `from` import takes is a
    submodule there or defined by the module (the copies hold no lazy
    import of a module not yet copied, but for the AWAITING ones, each
    in its one file)."""
    files = sorted((ROOT / "stellar_core_tpu_torch").rglob("*.py"))
    unresolved = {}
    checked = 0
    for path in files + [ROOT / "chip_smoke.py"]:
        parts = path.relative_to(ROOT).with_suffix("").parts
        module = ".".join(parts)      # a package's is pkg.__init__
        for line, name, names in port_imports(path.read_text(), module):
            checked += 1
            where = f"{path.relative_to(ROOT)}:{line}"
            if _module_file(name) is None:
                if AWAITING.get(name) != str(path.relative_to(ROOT)):
                    unresolved[where] = name
                continue
            mod = None
            for n in names:
                if n == "*" or _module_file(f"{name}.{n}") is not None:
                    continue
                mod = mod or importlib.import_module(name)
                if not hasattr(mod, n):
                    unresolved[where] = f"{name}.{n}"
    assert checked > 200
    assert unresolved == {}


def test_the_resolve_walk_sees_relative_and_lazy_imports():
    src = ("from ..herder.tx_queue import TransactionQueue\n"
           "def f():\n    from .. import work\n"
           "    import stellar_core_tpu_torch.historywork.works\n")
    found = port_imports(src, "stellar_core_tpu_torch.ledger.manager")
    assert [(n, names) for _, n, names in found] == [
        ("stellar_core_tpu_torch.herder.tx_queue", ("TransactionQueue",)),
        ("stellar_core_tpu_torch", ("work",)),
        ("stellar_core_tpu_torch.historywork.works", ())]
    assert _module_file("stellar_core_tpu_torch.simulation.hashseed_diff") \
        is not None
    assert _module_file("stellar_core_tpu_torch.lint") is not None
    assert _module_file("stellar_core_tpu_torch.no_such_module") is None
    assert _module_file("stellar_core_tpu_torch.simulation.chaos") is not None
    assert _module_file("stellar_core_tpu_torch.overlay.peer") is not None
    assert _module_file("stellar_core_tpu_torch.herder.tx_queue") is not None
    assert _module_file("stellar_core_tpu_torch.catchup.catchup") is not None
    assert _module_file("stellar_core_tpu_torch.ledger") is not None


@pytest.mark.parametrize("source, flagged", [
    ("def f():\n    from stellar_core_tpu import _capply\n", True),
    ("def f():\n    if x:\n        import jax.numpy as jnp\n", True),
    ("from stellar_core_tpu.xdr import scp\n", True),
    ("import importlib\nimportlib.import_module('stellar_core_tpu.accel')\n",
     True),
    ("__import__('jax')\n", True),
    ("from ... import x\n", True),          # past the package root
    ("from stellar_core_tpu_torch import _cxdr\n", False),
    ("import jaxtyping\nimport stellar_core_tpu_torch.xdr\n", False),
    ("from .. import xdr as X\nfrom .codec import pack\n", False),
])
def test_the_import_walk_finds_what_it_should(source, flagged):
    found = forbidden_imports(source, "stellar_core_tpu_torch.xdr.codec")
    assert bool(found) == flagged, found


def _one_signature():
    from stellar_core_tpu_torch.crypto import sodium
    pk, sk = sodium.sign_seed_keypair(bytes(32))
    return [pk], [sodium.sign_detached(b"m", sk)], [b"m"]


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ed25519.verify_batch(*_one_signature())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ed25519.verify_batch_async(*_one_signature())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ed25519.Ed25519BatchVerifier()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ed25519.verify_batch(*_one_signature(), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quorum.check_intersection_cuda(testutils.flat_qmap(4, 3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quorum.CudaQuorumIntersectionChecker(testutils.flat_qmap(4, 3),
                                             device="cuda")
    with pytest.raises(ValueError):
        device.resolve("meta")
    assert device.resolve("cpu") == torch.device("cpu")


def test_catchup_accel_raises_without_cuda(monkeypatch):
    """CatchupManager(accel=True) and the preverify pipeline, given no
    device, raise where there is no card: no replay on the CPU's plain
    versions unless asked for."""
    from stellar_core_tpu_torch.catchup.catchup import (CatchupManager,
                                                        PreverifyPipeline)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nid = testutils.network_id("no card net")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CatchupManager(nid, "no card net", accel=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PreverifyPipeline(nid, 256)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CatchupManager(nid, "no card net", accel=True,
                       accel_devices=["cuda", "cuda"])
    assert CatchupManager(nid, "no card net", accel=False).accel is False
    assert PreverifyPipeline(nid, 256, device="cpu").devices == (
        torch.device("cpu"),)


def test_graft_entry_and_sharded_forms_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multigpu(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ed25519.Ed25519BatchVerifier(devices=["cuda", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quorum.CudaQuorumIntersectionChecker(testutils.flat_qmap(4, 3),
                                             devices=["cuda"] * 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device.resolve_all(["cpu", "cuda"])


def test_windows_wrapper_refuses_non_cpu_tensors():
    """K-W's wrapper sends a tensor off the CPU to the kernel's checks,
    never to the plain version."""
    m = lambda *shape, dtype=torch.uint8: torch.empty(shape, dtype=dtype,
                                                      device="meta")
    launches = ed25519.verify_windows.launches
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        ed25519.verify_windows(m(127, 4, dtype=torch.int32), m(4, 3, 32),
                               m(4, 32))
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        ed25519.verify_windows(m(127, 4, dtype=torch.int32), m(4, 3, 32),
                               m(4, 32), count=m(1, dtype=torch.int32))
    assert ed25519.verify_windows.launches == launches


def test_wrappers_refuse_non_cpu_tensors_instead_of_running_plain():
    """A tensor off the CPU goes to the kernel or raises: here, tensors on
    the meta device reach the kernel path's checks and are refused."""
    m = lambda *shape, dtype=torch.uint8: torch.empty(shape, dtype=dtype, device="meta")
    counts = (ed25519.verify_generic.launches, tables.verify_tables.launches,
              tables.build_tables_into.launches, field.fe_check.launches,
              tables.dbl_chain.launches)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        ed25519.verify_generic(m(4, 32), m(4, 32), m(4, dtype=torch.int32),
                               m(1, 3, 32), m(4, 32))
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        tables.verify_tables(m(4, 32), m(4, 32), m(4, dtype=torch.int32),
                             m(4, 32), m(2, 64, 16, 4, 32), m(64, 16, 4, 32))
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        tables.build_tables_into(m(2, 64, 16, 4, 32),
                                 m(1, dtype=torch.int32), m(1, 2, 32))
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        field.fe_check(m(4, 32), m(4, 32), 0)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        tables.dbl_chain(m(1, 2, 32), 4)
    assert counts == (ed25519.verify_generic.launches,
                      tables.verify_tables.launches,
                      tables.build_tables_into.launches, field.fe_check.launches,
                      tables.dbl_chain.launches)


def test_quorum_wrappers_refuse_non_cpu_tensors():
    m = lambda *shape, dtype=torch.int64: torch.empty(shape, dtype=dtype,
                                                      device="meta")
    table = (m(3, dtype=torch.int32), m(3, 1), m(3, 2, dtype=torch.int32),
             m(3, 2, 1))
    counts = (quorum.flags_kernel.launches, quorum.compact_kernel.launches)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        quorum.prune_step(m(8, 1), m(1), m(1), *table)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        quorum.segment_step(m(16, 1), 1, m(4, 1), m(4, 1),
                            np.ones(4, dtype=bool), m(1), *table)
    assert counts == (quorum.flags_kernel.launches,
                      quorum.compact_kernel.launches)
    # on the CPU: the plain versions, no launch
    cpu = quorum.CudaQuorumIntersectionChecker(testutils.flat_qmap(4, 3),
                                               device="cpu")
    assert cpu.check().intersects
    assert counts == (quorum.flags_kernel.launches,
                      quorum.compact_kernel.launches)


def test_cpu_runs_take_the_plain_versions_and_count_no_launches():
    before = (ed25519.verify_generic.launches, field.fe_check.launches)
    v = ed25519.Ed25519BatchVerifier(chunk_size=8, hot_threshold=1 << 62,
                                     device="cpu")
    assert v.verify(*_one_signature()).tolist() == [True]
    a = torch.zeros((2, 32), dtype=torch.uint8)
    field.fe_check(a, a, 0)
    assert (ed25519.verify_generic.launches, field.fe_check.launches) == before
    assert v.stats["generic_sigs"] == 1


def test_missing_nvcc_is_an_error(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_build.library("tables")
    assert not (tmp_path / "build").exists()


def test_ptxas_report_parses_registers_and_spills():
    log = ("ptxas info    : Compiling entry function '_Z21verify_generic_kernelPKh' "
           "for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z21verify_generic_kernelPKh\n"
           "    2640 bytes stack frame, 24 bytes spill stores, 24 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 0 barriers, 400 bytes cmem[0]\n")
    assert _cuda_build.ptxas_summary(log) == {"_Z21verify_generic_kernelPKh": {
        "registers": 168, "stack": 2640, "spill_stores": 24, "spill_loads": 24}}


def test_library_path_tracks_the_sources():
    assert _cuda_build.SOURCES == ("verify_generic", "tables", "fe_check",
                                   "quorum")
    paths = {n: _cuda_build.library_path(n) for n in _cuda_build.SOURCES}
    assert all(p.parent == _cuda_build.BUILD_DIR for p in paths.values())
    assert len(set(paths.values())) == len(paths)
    assert all((_cuda_build.CSRC / f"{n}.cu").exists() for n in paths)
