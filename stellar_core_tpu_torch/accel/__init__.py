"""Accelerator layer of the port: batched Ed25519 verification.

Counterpart of ``stellar_core_tpu/accel``.  There is no process-wide switch
here: torch's int64 is native, so the plain versions' 16x16-bit limb math is
exact without the ``jax_enable_x64`` flag the JAX package sets on import.
That flag changes only what JAX computes, never what torch computes, so the
differential tests may import both packages in one process.
"""
