"""The port's own copy of the host utilities (stellar_core_tpu/util)."""
