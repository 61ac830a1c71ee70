"""Build-on-demand for the native XDR codec (native/cxdr.c), the
native apply engine (native/capply.c) and the quorum-intersection
enumeration core (native/cquorum.c).

Counterpart of stellar_core_tpu/_native_build.py, reduced to ``_cxdr``,
``_capply`` and ``_cquorum``.  The compiled libraries are not tracked in
git: at first use ``load(mod)`` compiles the repo-root C source with the
host C compiler into build/torch_native/, rebuilds it there whenever the
source is newer, and imports it as ``stellar_core_tpu_torch.<mod>``.  A
missing compiler or a failed build raises ImportError, and the caller
then runs its pure-Python path (xdr/codec.py, the Python ledger close,
the Python enumeration), as the reference's does.  The apply engine
dlopen()s libsodium; a Python extension resolves dlopen against the
interpreter, which always has it, so no ``-ldl`` is linked.
"""

from __future__ import annotations

import fcntl
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BUILD_DIR = REPO / "build" / "torch_native"

# module name -> C source (relative to the repo root)
EXTENSIONS = {"_cxdr": "native/cxdr.c",
              "_capply": "native/capply.c",
              "_cquorum": "native/cquorum.c"}

# setup.py's flags: the sources are warning-clean under them
_CFLAGS = ["-O2", "-Wall", "-Wextra"]


def _cc():
    return os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")


def library_path(mod: str) -> Path:
    return BUILD_DIR / (mod + sysconfig.get_config_var("EXT_SUFFIX"))


def stale(mod: str) -> bool:
    """True when `mod`'s library is missing or older than its source."""
    so = library_path(mod)
    src = REPO / EXTENSIONS[mod]
    return not so.exists() or so.stat().st_mtime < src.stat().st_mtime


def ensure(mod: str) -> Path:
    """`mod`'s library, built first if it is missing or stale.  Processes
    that build at once take turns on a lock file, and a build is written
    to a temporary name and renamed, so no process loads a half-written
    library.  Raises ImportError when the build cannot run or fails."""
    if mod not in EXTENSIONS:
        raise ValueError(f"unknown native extension {mod!r}")
    src = REPO / EXTENSIONS[mod]
    if not src.exists():
        raise ImportError(f"{src} is missing")
    so = library_path(mod)
    if not stale(mod):
        return so
    cc = _cc()
    if cc is None:
        raise ImportError("no C compiler on PATH")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / f".{mod}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not stale(mod):
                return so
            tmp = so.with_name(f".{so.name}.{os.getpid()}")
            cmd = [cc, "-shared", "-fPIC", *_CFLAGS, "-I",
                   sysconfig.get_paths()["include"], str(src), "-o", str(tmp)]
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise ImportError(f"building {mod} failed:\n{res.stderr}")
            os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError) as e:
        raise ImportError(f"building {mod} failed: {e}") from e
    return so


def load(mod: str):
    """Import `mod` from its built library as stellar_core_tpu_torch.<mod>,
    building it first where needed (see ensure)."""
    name = f"{__package__}.{mod}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, ensure(mod))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    sys.modules[name] = module
    return module
