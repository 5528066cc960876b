"""Permutohedral lattice pyramid on the device (static shapes)."""

from .offsets import filter_size, neighborhood_offsets, tap_negation  # noqa: F401
from .build import (  # noqa: F401
    CloudLattice,
    CloudScale,
    LatticeSpec,
    ScalePair,
    ScaleSpec,
    build_pyramid,
    build_scales,
    default_capacities,
    probe_sharding,
)
