"""PyTorch + CUDA port of the stellar_core_tpu accelerator layer.

This package runs the batched Ed25519 verification that catchup replay
offloads (``stellar_core_tpu.accel``) on an NVIDIA H100 through kernels
written by hand in CUDA C++ (``csrc/``), each with a plain PyTorch version
beside it, and keeps its own copies of the host modules around that offload
(``util``, ``crypto``, ``xdr`` with the native serializer native/cxdr.c,
``transactions.signature_checker``) and of the state and apply layer a
ledger close runs (``bucket``, ``transactions``, ``soroban``,
``invariant``, ``ledger`` with the native apply engine native/capply.c,
``database``, ``history.archive``, ``herder.upgrades``) and of the
catchup seam that replays a history archive (``work``, ``historywork``,
``catchup`` with range-parallel catchup, ``history.manager``,
``simulation.loadgen``, ``util.process``, ``main.config`` and the
catchup subcommands of ``main.commandline``: ``python -m
stellar_core_tpu_torch catchup``), and of every other module of the JAX
package, corelint (``lint``, retargeted at this package's tree) and the
hash-seed differential (``simulation.hashseed_diff``) included.  It imports
``torch``, numpy and the standard library only: never ``jax`` and nothing
of ``stellar_core_tpu``.
Where it needs code from the JAX package it keeps its own copy, under the
same module name so a reader can find each counterpart.

Entry points run on CUDA unless the caller passes ``device="cpu"``, which
selects the plain versions (the CPU tests do so); see ``device.resolve``.
"""

# With STPU_NATIVE_SANITIZE=1 the ASan+UBSan instrumented native libraries
# (build/torch_native/asan/, see _native_build) replace the plain ones for
# this process; `python -m stellar_core_tpu_torch._native_build --asan-exec
# CMD...` runs CMD so, with the sanitizer runtime preloaded.
import os as _os

if _os.environ.get("STPU_NATIVE_SANITIZE") == "1":
    from . import _native_build as _nb

    _nb.activate_sanitized()

# Every pass of the cyclic collector is timed into `process.gc-pause`.
from .util import tracing as _tracing  # noqa: E402

_tracing.install_gc_pause_timer()
