"""wall.fwd_pairs_per_s: ``fwd_pairs_per_s`` (pairs whose flow reached the
host in the window, over the window's seconds) where the forward is
host-bound: per layer, since it follows the speed of the host's cores from
run to run further than a bound can hold."""

from flowbench.metrics.fwd_pairs_per_s import read  # noqa: F401
