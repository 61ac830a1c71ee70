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

The other half is the reference's sanitizer and warning gate, with its
semantics: ``warn_check`` recompiles every source with ``-Wall -Wextra
-Werror``; ``ensure_sanitized`` builds ASan+UBSan libraries into their
own directory, build/torch_native/asan/, which ``load`` takes from once
``activate_sanitized`` ran (the package calls it when
STPU_NATIVE_SANITIZE=1); ``require_fresh`` fail-stops an import site
whose library is present, stale and cannot be rebuilt.  The command line
(``python -m stellar_core_tpu_torch._native_build --warn-check``,
``--sanitize``, ``--asan-exec CMD...``) is the reference's.
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
_REPO = str(REPO)
# the package's directory: no library is built into it (see BUILD_DIR)
_PKG = os.path.join(_REPO, "stellar_core_tpu_torch")

# module name -> C source (relative to the repo root)
EXTENSIONS = {"_cxdr": "native/cxdr.c",
              "_capply": "native/capply.c",
              "_cquorum": "native/cquorum.c"}
_EXTENSIONS = EXTENSIONS

# setup.py's flags; --warn-check recompiles with -Werror so that a warning
# fails the gate (native/capply.c has 19 under GCC 11 and later: its
# declarations lack the array bound its definitions give, -Warray-parameter)
_WARN_FLAGS = ["-Wall", "-Wextra"]
_CFLAGS = ["-O2", *_WARN_FLAGS]

# the sanitizer build: ASan+UBSan over the whole engine, in a directory of
# its own so that it never shadows the plain build unless activated
_SANITIZE_FLAGS = ["-fsanitize=address,undefined", "-fno-omit-frame-pointer",
                   "-g", "-O1"]
_ASAN_DIR = str(BUILD_DIR / "asan")
_ASAN_OPTIONS = "detect_leaks=0:halt_on_error=1:abort_on_error=1"
_UBSAN_OPTIONS = "halt_on_error=1:print_stacktrace=1"
_sanitized = False          # load() takes _ASAN_DIR's libraries when set


def _cc():
    return os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")


def _py_include():
    return sysconfig.get_paths()["include"]


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
            cmd = [cc, "-shared", "-fPIC", *_CFLAGS, "-I", _py_include(),
                   str(src), "-o", str(tmp)]
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
    if _sanitized:
        if not ensure_sanitized():
            raise ImportError(f"the sanitized build of {mod} failed")
        path = _sanitized_path(mod)
    else:
        path = ensure(mod)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    sys.modules[name] = module
    return module


def _stale():
    """The extensions whose library is missing or older than its source."""
    return [mod for mod, src in EXTENSIONS.items()
            if (REPO / src).exists() and stale(mod)]


def ensure_native(quiet=True):
    """Build every missing or stale extension.  Returns True when each one
    that has a source is built and current."""
    for mod in _stale():
        try:
            ensure(mod)
        except ImportError as e:
            if not quiet:
                sys.stderr.write(f"native build failed: {e}\n")
    return not _stale()


class StaleNativeExtensionError(RuntimeError):
    """A built library is older than its C source and could not be
    rebuilt: loading it would run code that no longer matches native/*.c,
    past the differential tests that are supposed to validate it."""


def require_fresh(mod):
    """Staleness guard for an import site that loads `mod`: a MISSING
    library leaves the caller's fallback (False), a current one is fine
    (True), and a PRESENT-and-stale one is rebuilt or the import
    fail-stops (StaleNativeExtensionError)."""
    if mod not in EXTENSIONS:
        raise ValueError(f"unknown native extension {mod!r}")
    if not library_path(mod).exists():
        return False
    if not stale(mod):
        return True
    ensure_native()
    if stale(mod):
        raise StaleNativeExtensionError(
            f"{mod} is older than {EXTENSIONS[mod]} and the rebuild failed; "
            f"see `python -m stellar_core_tpu_torch._native_build "
            f"--warn-check` (or set STELLAR_TPU_NO_CAPPLY=1 to force the "
            f"Python engine)")
    return True


def _sanitized_path(mod):
    return os.path.join(_ASAN_DIR, mod + ".so")


def _stale_sanitized():
    out = []
    for mod, src in EXTENSIONS.items():
        src_path = REPO / src
        if not src_path.exists():
            continue
        so = _sanitized_path(mod)
        if not os.path.exists(so) \
                or os.path.getmtime(so) < src_path.stat().st_mtime:
            out.append(mod)
    return out


def ensure_sanitized(quiet=True):
    """Build the ASan+UBSan instrumented libraries under
    build/torch_native/asan/ where missing or older than their sources.
    Returns True when every extension with a source is built and current;
    False (never raises) when the compiler is missing or a compile fails,
    so callers skip the sanitizer tier as the plain build falls back.  A
    build is written to a temporary name and renamed, under ensure's lock
    file, so no process loads a half-written library."""
    if not _stale_sanitized():
        return True
    cc = _cc()
    if cc is None:
        return False
    os.makedirs(_ASAN_DIR, exist_ok=True)
    with open(os.path.join(_ASAN_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for mod in _stale_sanitized():
            so = _sanitized_path(mod)
            tmp = f"{so}.{os.getpid()}"
            cmd = [cc, "-shared", "-fPIC", *_WARN_FLAGS, *_SANITIZE_FLAGS,
                   "-I", _py_include(), str(REPO / EXTENSIONS[mod]),
                   "-o", tmp]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=300)
            except Exception as e:  # corelint: disable=exception-hygiene -- missing/failed sanitizer toolchain: fall back like the plain build
                if os.path.exists(tmp):
                    os.unlink(tmp)
                if not quiet:
                    sys.stderr.write(f"sanitized build failed: {e}\n")
                return False
            if res.returncode != 0:
                if not quiet:
                    sys.stderr.write(res.stdout + res.stderr)
                if os.path.exists(tmp):
                    os.unlink(tmp)
                return False
            os.replace(tmp, so)
    return not _stale_sanitized()


def libasan_path():
    """Path to the compiler's dynamic ASan runtime, or None.  The
    instrumented libraries are loaded into an uninstrumented python, so
    the runtime must be LD_PRELOADed into the process."""
    cc = _cc()
    if cc is None:
        return None
    try:
        res = subprocess.run([cc, "-print-file-name=libasan.so"],
                             capture_output=True, text=True, timeout=30)
    except Exception:  # corelint: disable=exception-hygiene -- probe-only: absent toolchain means no sanitizer tier
        return None
    path = res.stdout.strip()
    if res.returncode != 0 or not path or not os.path.isabs(path) \
            or not os.path.exists(path):
        return None
    return path


def sanitizer_available():
    return _cc() is not None and libasan_path() is not None


def sanitizer_env(base=None):
    """Environment for running python with the sanitized engine active:
    LD_PRELOAD the ASan runtime, fail-stop sanitizer options
    (halt_on_error=1; leak checking off, since CPython frees nothing at
    exit), and STPU_NATIVE_SANITIZE=1 so the package activates the
    instrumented build."""
    env = dict(os.environ if base is None else base)
    lib = libasan_path()
    if lib:
        prev = env.get("LD_PRELOAD")
        env["LD_PRELOAD"] = lib + ((" " + prev) if prev else "")
    env.setdefault("ASAN_OPTIONS", _ASAN_OPTIONS)
    env.setdefault("UBSAN_OPTIONS", _UBSAN_OPTIONS)
    env["STPU_NATIVE_SANITIZE"] = "1"
    return env


def activate_sanitized(quiet=True):
    """Make ``load`` (and so ``xdr``'s codec, the apply engine and the
    quorum enumeration) take the instrumented libraries: build them if
    stale, then switch.  Called from the package's __init__ when
    STPU_NATIVE_SANITIZE=1.  Returns False (the plain libraries stay)
    when the sanitizer toolchain is unavailable."""
    global _sanitized
    for mod in EXTENSIONS:
        # too late to swap an engine already loaded: fail before the
        # (expensive) sanitized build, not after
        if f"{__package__}.{mod}" in sys.modules:
            raise RuntimeError(
                f"activate_sanitized() after {__package__}.{mod} was "
                f"already loaded; set STPU_NATIVE_SANITIZE=1 in the "
                f"process environment instead")
    if not ensure_sanitized(quiet=quiet):
        return False
    _sanitized = True
    return True


def warn_check(werror=True, quiet=False):
    """Compile every native source with -Wall -Wextra (-Werror when
    `werror`), object code to /dev/null: the lint gate that keeps the
    default build warning-clean.  Returns (ok, details); ok is True with
    a notice when no compiler is available (the build itself would then
    have fallen back too)."""
    cc = _cc()
    if cc is None:
        return True, ["warn-check skipped: no C compiler on PATH"]
    details = []
    ok = True
    # a real -O2 compile, not -fsyntax-only: the optimization-dependent
    # dataflow warnings (-Wmaybe-uninitialized, -Wstrict-aliasing) fire
    # only when the passes that feed them run
    flags = ["-c", "-O2", "-o", os.devnull] + _WARN_FLAGS \
        + (["-Werror"] if werror else [])
    for mod, src in EXTENSIONS.items():
        src_path = REPO / src
        if not src_path.exists():
            continue
        try:
            res = subprocess.run(
                [cc] + flags + ["-I", _py_include(), str(src_path)],
                capture_output=True, text=True, timeout=300)
        except Exception as e:  # corelint: disable=exception-hygiene -- wedged compiler: report as a structured FAIL, not a traceback
            ok = False
            details.append(f"{src}: FAIL (compiler did not finish: {e})")
            continue
        if res.returncode != 0:
            ok = False
            details.append(f"{src}: FAIL\n{res.stderr.strip()}")
        else:
            details.append(f"{src}: warning-clean")
    return ok, details


def _main(argv):
    """CLI: `python -m stellar_core_tpu_torch._native_build <mode>`.

    --warn-check         -Wall -Wextra -Werror compile of every native
                         source (the lint gate); exit 1 on any warning,
                         0 when clean or when no compiler exists
                         (fallback intact, notice printed)
    --sanitize           build the ASan+UBSan libraries under
                         build/torch_native/asan
    --asan-exec CMD...   build sanitized, then exec CMD with the
                         sanitizer environment (LD_PRELOAD runtime,
                         halt_on_error, STPU_NATIVE_SANITIZE=1); exits 0
                         with a SKIPPED notice when the toolchain is
                         missing, so a tier degrades instead of erroring
    """
    if not argv:
        sys.stderr.write(_main.__doc__ + "\n")
        return 2
    mode, rest = argv[0], argv[1:]
    if mode == "--warn-check":
        ok, details = warn_check()
        for d in details:
            print(d)
        return 0 if ok else 1
    if mode == "--sanitize":
        if not sanitizer_available():
            print("sanitize SKIPPED: no cc/libasan in this environment")
            return 0
        ok = ensure_sanitized(quiet=False)
        print("sanitized build: " + ("ok" if ok else "FAILED"))
        return 0 if ok else 1
    if mode == "--asan-exec":
        if not rest:
            sys.stderr.write("--asan-exec needs a command\n")
            return 2
        if not sanitizer_available():
            print("native-asan SKIPPED: no cc/libasan in this environment")
            return 0
        if not ensure_sanitized(quiet=False):
            sys.stderr.write("sanitized build FAILED\n")
            return 1
        os.execvpe(rest[0], rest, sanitizer_env())
    sys.stderr.write(f"unknown mode {mode!r}\n{_main.__doc__}\n")
    return 2


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
