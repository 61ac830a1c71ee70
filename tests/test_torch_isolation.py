"""The port stands alone and never falls back.

* Importing every module of stellar_core_tpu_torch and chip_smoke leaves
  jax and stellar_core_tpu out of sys.modules (fresh subprocess).
* With no device argument and no CUDA, the entry points raise.
* The CUDA wrappers never run their plain version on a tensor that is not
  on the CPU, and a missing nvcc is an error, not a fallback.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stellar_core_tpu_torch import _cuda_build, device
from stellar_core_tpu_torch.accel import ed25519, field, tables

ROOT = Path(__file__).resolve().parent.parent
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in (ROOT / "stellar_core_tpu_torch").rglob("*.py"))


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    assert "stellar_core_tpu_torch.accel.ed25519" in PORT_MODULES
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
    with pytest.raises(ValueError):
        device.resolve("meta")
    assert device.resolve("cpu") == torch.device("cpu")


def test_wrappers_refuse_non_cpu_tensors_instead_of_running_plain():
    """A tensor off the CPU goes to the kernel or raises: here, tensors on
    the meta device reach the kernel path's checks and are refused."""
    m = lambda *shape, dtype=torch.uint8: torch.empty(shape, dtype=dtype, device="meta")
    counts = (ed25519.verify_generic.launches, tables.verify_tables.launches,
              tables.build_tables_into.launches, field.fe_check.launches)
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
    assert counts == (ed25519.verify_generic.launches,
                      tables.verify_tables.launches,
                      tables.build_tables_into.launches, field.fe_check.launches)


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
    paths = {n: _cuda_build.library_path(n) for n in _cuda_build.SOURCES}
    assert all(p.parent == _cuda_build.BUILD_DIR for p in paths.values())
    assert len(set(paths.values())) == len(paths)
    assert all((_cuda_build.CSRC / f"{n}.cu").exists() for n in paths)
