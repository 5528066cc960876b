"""wall.fwd_p95_ms: ``fwd_p95_ms`` (the 95th percentile of every request of
the window, host arrays in to flow on the host) where the forward is
host-bound: per layer, since it follows the speed of the host's cores from
run to run further than a bound can hold."""

from flowbench.metrics.fwd_p95_ms import read  # noqa: F401
