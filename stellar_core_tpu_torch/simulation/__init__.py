"""Simulation layer: in-process multi-node networks + load generation.

Reference: src/simulation/ (SURVEY.md §2.1).  The copy of
stellar_core_tpu/simulation/, so far its LoadGenerator and its in-process
networks (simulation.simulation); the chaos campaigns and the fleet are
not ported yet.
"""

from .loadgen import LoadGenerator
from .simulation import (SimNode, Simulation, make_asymmetric_topology,
                         make_core_topology, make_cycle_topology,
                         make_hierarchical_topology, qset_of)

__all__ = ["LoadGenerator", "SimNode", "Simulation",
           "make_asymmetric_topology", "make_core_topology",
           "make_cycle_topology", "make_hierarchical_topology",
           "qset_of"]
