"""Simulation layer: in-process multi-node networks + load generation +
chaos campaigns.

Reference: src/simulation/ (SURVEY.md §2.1).  The copy of
stellar_core_tpu/simulation/: its LoadGenerator, its in-process networks
(simulation.simulation), the chaos campaigns on them (simulation.chaos),
ApplyLoad (simulation.apply_load) and the multi-process TCP fleet
(simulation.fleet) and the hash-seed differential
(simulation.hashseed_diff).
"""

from .loadgen import LoadGenerator
from .simulation import (SimNode, Simulation, make_asymmetric_topology,
                         make_core_topology, make_cycle_topology,
                         make_hierarchical_topology, qset_of)

__all__ = ["LoadGenerator", "SimNode", "Simulation",
           "make_asymmetric_topology", "make_core_topology",
           "make_cycle_topology", "make_hierarchical_topology",
           "qset_of"]
