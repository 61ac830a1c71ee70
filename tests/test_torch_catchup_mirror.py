"""The reference's own catchup tests, run on both packages and compared.

Each case of tests/test_work.py, test_historywork.py,
test_history_catchup.py, test_catchup_parallel.py and test_catchup_mesh.py
runs on ``stellar_core_tpu`` and again, compiled against it, on
``stellar_core_tpu_torch`` (test_torch_mirror.py): the outcomes must be
equal and every ledger close the same hash and result set, byte for byte.
The port's preverify pipeline is pinned to the plain versions on the CPU
(``PreverifyPipeline.DEFAULT_DEVICE = "cpu"``, as the reference's tests pin
DEFAULT_PROFILE), and through it its parallel catchup's range workers
(``--accel cpu``).  Range workers are subprocesses: each runs on one torch
thread, as does this process.

Left out, because they assert on jax itself: test_history_catchup.py's
``test_accel_catchup_end_to_end_on_8dev_mesh`` (the reference's verifier
sharded over jax's eight CPU devices) and test_catchup_mesh.py's
``TestMeshPinning.test_env_shapes_per_platform``,
``test_cpu_mesh_env_actually_pins_one_device`` and
``test_mesh_env_threads_through_worker_cmdline`` (the XLA_FLAGS and
TPU_VISIBLE_DEVICES that the reference's mesh sets; the port's own mesh
env is tested in test_torch_catchup.py).

STRAGGLER: test_catchup_mesh.py's straggler range sleeps 1 s a checkpoint,
so in ``test_straggler_steal_beats_no_steal`` the steal gains about 1 s
against the start of a thief process, which a loaded machine can take
longer than; the case then fails on its wall-clock comparison (:415),
on either package.  Its mirror makes the straggler sleep
``STRAGGLER_THROTTLE_S`` a checkpoint, in both packages, so the race the
case asserts the steal wins is won by seconds; every assertion of the
case stands as it is.
"""

from __future__ import annotations

import importlib

import pytest
import torch

from test_torch_mirror import PORT, REF, assert_mirrored, cases

JAX_ONLY = {
    ("test_history_catchup.py", "test_accel_catchup_end_to_end_on_8dev_mesh"),
    ("test_catchup_mesh.py", "TestMeshPinning.test_env_shapes_per_platform"),
    ("test_catchup_mesh.py",
     "TestMeshPinning.test_cpu_mesh_env_actually_pins_one_device"),
    ("test_catchup_mesh.py",
     "TestMeshPinning.test_mesh_env_threads_through_worker_cmdline"),
}
STRAGGLER = ("test_catchup_mesh.py", "test_straggler_steal_beats_no_steal")
STRAGGLER_THROTTLE_S = "4.0"
FILES = ("test_work.py", "test_historywork.py", "test_history_catchup.py",
         "test_catchup_parallel.py", "test_catchup_mesh.py")


@pytest.fixture(autouse=True)
def plain_versions_on_one_thread(monkeypatch):
    from stellar_core_tpu_torch.catchup.catchup import PreverifyPipeline
    monkeypatch.setattr(PreverifyPipeline, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("filename, case", [
    (f, c) for f in FILES for c in cases(f) if (f, c) not in JAX_ONLY])
def test_reference_catchup_tests_on_both_packages(filename, case,
                                                  monkeypatch):
    if (filename, case) == STRAGGLER:
        slower_straggler(monkeypatch)
    assert_mirrored(filename, case)


def slower_straggler(monkeypatch) -> None:
    """ParallelCatchup of both packages with every range's
    STPU_CATCHUP_THROTTLE_S raised to STRAGGLER_THROTTLE_S."""
    for root in (REF, PORT):
        cls = importlib.import_module(f"{root}.catchup.parallel") \
            .ParallelCatchup

        def init(self, *args, extra_env=None, _init=cls.__init__, **kw):
            extra_env = {
                i: {**env, "STPU_CATCHUP_THROTTLE_S": STRAGGLER_THROTTLE_S}
                if "STPU_CATCHUP_THROTTLE_S" in env else env
                for i, env in (extra_env or {}).items()}
            _init(self, *args, extra_env=extra_env, **kw)

        monkeypatch.setattr(cls, "__init__", init)


def test_left_out_cases_exist():
    """Each left-out case is one the files still have, and so is the
    straggler case."""
    for f, c in JAX_ONLY:
        assert c in cases(f), (f, c)
    assert STRAGGLER[1] in cases(STRAGGLER[0])
