"""Build the CUDA sources with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``build/torch_kernels/<name>-<digest>.so``, where the digest
covers the source, every header in ``csrc/`` and the compiler flags: a
changed source never loads a stale binary (the rule of
``stellar_core_tpu._native_build.require_fresh``), and an unchanged one is
not rebuilt.  The sources are compiled in parallel, one nvcc each, at first
use, so a fresh checkout needs nothing built ahead.  A build that fails
raises; nothing falls back to the plain versions.

Each C entry point launches one kernel on the stream it is given (its last
argument), returns ``cudaGetLastError()``, and never synchronises; ``launch``
calls it and raises on an error.  Every pointer and the stream go through
ctypes as ``c_void_p`` (a pointer passed as a plain int would be cut to 32
bits).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
SOURCES = ("verify_generic", "tables", "fe_check")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}      # name -> ctypes.CDLL
_fns: dict = {}       # (name, fn) -> bound ctypes function


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, else PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(names=SOURCES) -> None:
    """Compile every source in `names` whose library is missing, all nvcc
    processes at once, and keep nvcc's ptxas report (registers and spills
    per kernel) beside each library as <name>-<digest>.ptxas.txt.  Raises
    RuntimeError naming each source that failed."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, out)          # atomic: readers never see half a file
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))


def ptxas_report(name: str) -> dict:
    """The ptxas summary of the built library `name` (see ptxas_summary)."""
    return ptxas_summary(
        library_path(name).with_suffix(".ptxas.txt").read_text())


def ptxas_summary(log: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads", "stack"}} from
    nvcc's -Xptxas -v report."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = out.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return out


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def function(lib_name: str, fn_name: str, argtypes):
    """The C entry `fn_name` of library `lib_name`, with its argtypes set
    and an int (cudaError_t) result."""
    key = (lib_name, fn_name)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(library(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


# None, or a list that every launch appends (kernel, start, end) to, where
# start and end are CUDA timing events recorded around it on its stream:
# the sum of their elapsed times is the device time of the kernels a call
# ran (chip_smoke.py reads it as the call's device busy time).  Off by
# default; on, it costs two event records a launch.
launch_events = None


def launch(lib_name: str, kernel: str, entry, device: torch.device,
           *args) -> None:
    """Launch the C entry `entry` = (fn_name, argtypes) of library
    `lib_name` with `args` and the current stream of `device`; raise if it
    reports a CUDA error."""
    fn = function(lib_name, *entry)
    stream = torch.cuda.current_stream(device)
    events = launch_events
    if events is not None:
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
    rc = fn(*args, stream.cuda_stream)
    if rc != 0:
        msg = library(lib_name).cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} ({msg})")
    if events is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        events.append((kernel, start, end))


def check_tensors(what: str, device: torch.device, *specs) -> None:
    """specs: (tensor, dtype, shape).  Every tensor must be contiguous, of
    that dtype and shape, on `device`, which must be the current CUDA
    device (the kernels launch there)."""
    if device.type != "cuda":
        raise ValueError(f"{what}: expected CUDA tensors, got {device}")
    if device.index != torch.cuda.current_device():
        raise ValueError(f"{what}: tensors on {device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    for i, (t, dtype, shape) in enumerate(specs):
        if t.device != device:
            raise ValueError(f"{what}: argument {i} on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: argument {i} is {t.dtype}, not {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: argument {i} has shape "
                             f"{tuple(t.shape)}, not {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: argument {i} is not contiguous")
