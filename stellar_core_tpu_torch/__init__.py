"""PyTorch + CUDA port of the stellar_core_tpu accelerator layer.

This package runs the batched Ed25519 verification that catchup replay
offloads (``stellar_core_tpu.accel``) on an NVIDIA H100 through kernels
written by hand in CUDA C++ (``csrc/``), each with a plain PyTorch version
beside it, and keeps its own copies of the host modules around that offload
(``util``, ``crypto``, ``xdr`` with the native serializer native/cxdr.c,
``transactions.signature_checker``).  It imports ``torch``, numpy and the
standard library only: never ``jax`` and nothing of ``stellar_core_tpu``.
Where it needs code from the JAX package it keeps its own copy, under the
same module name so a reader can find each counterpart.

Entry points run on CUDA unless the caller passes ``device="cpu"``, which
selects the plain versions (the CPU tests do so); see ``device.resolve``.
"""
