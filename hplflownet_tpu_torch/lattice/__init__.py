"""Permutohedral lattice pyramid on the device (static shapes)."""

from .offsets import filter_size, neighborhood_offsets, tap_negation  # noqa: F401
from .build import (  # noqa: F401
    CloudLattice,
    LatticeSpec,
    ScalePair,
    ScaleSpec,
    build_pyramid,
    default_capacities,
    probe_sharding,
)
