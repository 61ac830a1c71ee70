"""Simulation layer: load generation.

Reference: src/simulation/ (SURVEY.md §2.1).  The copy of
stellar_core_tpu/simulation/, so far its LoadGenerator only: the
in-process multi-node networks (simulation.simulation) need the overlay,
which the port does not have yet.
"""

from .loadgen import LoadGenerator

__all__ = ["LoadGenerator"]
