"""What of chip_smoke.py runs without a card: its pure-Python RFC 8032
signer equals libsodium byte for byte, its fixed adversarial verdicts are
libsodium's, its kernel operation counts follow the device code, its
main-path runs count launches and kernel time per call, and the script
refuses to run (exit 2, no result) without CUDA and fails in a directory
that holds only itself."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from stellar_core_tpu_torch import _cuda_build
from stellar_core_tpu_torch.accel import ed25519, tables
from stellar_core_tpu_torch.crypto import sodium

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def libsodium():
    if not sodium.available():
        pytest.skip("libsodium is the oracle of these checks")


def test_python_signer_equals_libsodium(libsodium):
    for i in range(4):
        seed = bytes([i * 7 + 1]) * 32
        pk, sk = chip_smoke.py_keypair(seed)
        spk, ssk = sodium.sign_seed_keypair(seed)
        assert pk == spk
        for msg in (b"", b"m", bytes(range(120))):
            assert chip_smoke.py_sign(msg, sk) == sodium.sign_detached(msg, ssk)


def test_adversarial_constants_are_libsodiums(libsodium, monkeypatch):
    cases = chip_smoke.adversarial_cases(chip_smoke.Signer())
    for name, triples, expected in cases:
        assert [sodium.verify_detached(s, m, p) for p, s, m in triples] == \
            expected, name
    # the fallback signer makes the very same vectors
    monkeypatch.setattr(chip_smoke.sodium, "available", lambda: False)
    signer = chip_smoke.Signer()
    assert signer.name == "python-rfc8032"
    assert chip_smoke.adversarial_cases(signer) == cases


def test_operation_counts():
    # per signature / per key, from the field-op counts of csrc/verify.cuh
    assert chip_smoke.kt_imads() == 254 * 55 + 1037 * 100
    assert chip_smoke.kg_imads() == 1274 * 55 + 2155 * 100
    # K-B's bound counts what the build needs (x*y once, the 252-doubling
    # chain, 142 multiplies a window); its design runs 8,064 doublings
    assert chip_smoke.kb_imads() == 1008 * 55 + (1 + 1008 + 64 * 142) * 100
    assert chip_smoke.kb_imads_run() == 32256 * 55 + 41408 * 100
    ms, by = chip_smoke.bound_ms(1e12, 1.0)
    assert by == "operations" and ms == pytest.approx(1e15 / (132 * 64 * 1.98e9))


class _Event:
    def __init__(self, at):
        self.at = at

    def elapsed_time(self, end):
        return end.at - self.at


def test_drive_counts_one_calls_launches_and_kernel_time():
    """drive() zeroes the counts before the call, reads them after, sums
    the device time of the launches the call recorded, and turns the event
    recording off again; report() divides it by the call's wall time."""
    tables.verify_tables.launches = 7

    def call():
        tables.verify_tables.launches += 2
        _cuda_build.launch_events.append(("K-T", _Event(1.0), _Event(1.5)))
        _cuda_build.launch_events.append(("K-T", _Event(2.0), _Event(2.25)))
        return np.ones(3, dtype=bool)

    run = chip_smoke.drive(call)
    assert _cuda_build.launch_events is None
    assert run["launches"] == {"K-B": 0, "K-T": 2, "K-G": 0}
    assert run["kernel_ms"] == 0.75 and run["verdicts"].all()
    rep = chip_smoke.report(run)
    assert rep["busy_share"] == pytest.approx(0.75 / (1e3 * run["seconds"]))
    # a CPU call launches nothing and records nothing
    run = chip_smoke.drive(lambda: ed25519.verify_batch(
        [b"\x00" * 32], [b"\x00" * 64], [b""], device="cpu"))
    assert run["kernel_ms"] == 0 and set(run["launches"].values()) == {0}


def test_main_without_cuda_exits_2_and_prints_nothing(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 2
    assert capsys.readouterr().out == ""


def test_alone_in_a_directory_it_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
