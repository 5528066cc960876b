"""The segment entry: ``pipeline.segment_forward`` on one cloud per request.

A request hands in one cloud's (N, 3) float32 host array (the first cloud
of a pool pair of ``generator.py``) and ends when its (N, classes) float32
logits are a host array: the session's page-locked buffer for that pool
cloud, made in set-up, as a client that labels sweep after sweep reuses
its buffers (a fresh pageable array would put 19.7 MB of first-touch page
faults into every request's copy, and into the card's busy time).  It
failed if the logits are not finite, or if the program's build of the
cloud drops a vertex or a point (its overflow counters, read after the
window).

``correct`` compares what the window served: a sample of finished
requests, drawn from the seed, against the reference's float32 logits
(``flowbench.reference.splatnet3d``) of the same cloud and weights.  The
number is the largest relative L2 gap ``||logits - ref|| / ||ref||`` over
the sample (``logits_rel_l2``).  The session keeps the last logits served
for each pool cloud, not one array per request (19.7 MB a 98304-point
request): the program is deterministic, so every request on a cloud
serves the same logits, and one that does not (``stale_logits``) is off
the reference.

The control is the reference with float8 e4m3 operands
(``flowbench.control.fp8``); the faults are ``stale_logits`` (a request
gets the previous request's logits), ``half_cloud`` (half of the cloud's
points are left out of every lattice) and ``no_bn`` (every BatchNorm left
out: the ReLUs stay).
"""

from __future__ import annotations

import numpy as np
import torch

from ..control import fp8
from ..reference import splatnet3d as ref
from ..reference.splatnet3d import init_params

__all__ = ["init_params", "Program", "Session", "Control", "CONTROL", "FAULTS"]


class Program:
    """The measured program's segmentation forward."""

    def __init__(self, cfg, capacities, params, device):
        from hplflownet_tpu_torch.models import MODELS
        from hplflownet_tpu_torch.pipeline import make_lattice_spec
        self.device = device
        self.model = MODELS[cfg["arch"]](
            cfg["scales_filter_map"], dim=cfg["dim"], embed_width=cfg["embed_width"],
            bcl_widths=cfg["bcl_widths"], head_width=cfg["head_width"],
            classes=cfg["classes"], compute_dtype=cfg["compute_dtype"], device=device)
        self.model.load_state_dict(params, strict=True)
        self.spec = make_lattice_spec(cfg["scales_filter_map"], capacities)

    def __call__(self, points: np.ndarray, valid: np.ndarray | None = None,
                 out: torch.Tensor | None = None) -> np.ndarray:
        """The logits as a host array: ``out`` (a host tensor) filled, or a
        new array."""
        from hplflownet_tpu_torch.pipeline import segment_forward
        logits = segment_forward(self.model, self.spec, points, valid)
        if out is None:
            return logits.cpu().numpy()
        return out.copy_(logits).numpy()

    def overflow(self, points: np.ndarray) -> int:
        """Vertices and points the program's build of the cloud drops."""
        from hplflownet_tpu_torch.lattice.build import build_scales
        with torch.inference_mode():
            scales = build_scales(self.spec, torch.from_numpy(points).to(self.device))
            return int(sum(sc.cloud.overflow for sc in scales))


class Session:
    entry = "forward"

    def __init__(self, cfg, capacities, mix, pool, params, seed, device,
                 program=Program):
        self.cfg, self.capacities, self.mix = cfg, capacities, mix
        self.pool, self.params, self.seed, self.device = pool, params, seed, device
        self.program = program(cfg, capacities, params, device)
        shape = (pool.pc1[0].shape[0], int(cfg["classes"]))
        self.host = [torch.empty(shape, pin_memory=device.type == "cuda")
                     for _ in pool.pc1]
        self.done = []            # pool index of each finished request
        self.latest = {}          # pool index -> its last served logits

    def warm(self, order) -> None:
        """Three requests on the first pool clouds (every cloud has the same
        shapes); ``order`` is left as it is."""
        for k in range(min(3, len(self.pool.pc1))):
            self.program(self.pool.pc1[k], out=self.host[k])

    def call(self, k: int) -> bool:
        logits = self.program(self.pool.pc1[k], out=self.host[k])
        self.done.append(k)
        self.latest[k] = logits
        return bool(np.isfinite(logits).all())

    def overflowing(self) -> set:
        """Pool clouds whose build drops work (after the window)."""
        return {k for k in self.latest if self.program.overflow(self.pool.pc1[k])}

    def release(self):
        self.program = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, k: int, log=None) -> torch.Tensor:
        x = torch.from_numpy(self.pool.pc1[k]).to(self.device)
        with torch.no_grad():
            return ref.forward(self.cfg, self.capacities, self.params, x, log=log)

    def check(self) -> dict:
        n = int(self.mix["check"]["requests"])
        rng = np.random.default_rng(np.random.SeedSequence([int(self.seed) % (1 << 64), 7]))
        picks = rng.choice(len(self.done), size=min(n, len(self.done)), replace=False)
        worst = 0.0
        for k in sorted({self.done[int(i)] for i in picks}):
            want = self._reference(k).cpu().numpy().astype(np.float64)
            gap = np.linalg.norm(self.latest[k].astype(np.float64) - want) \
                / np.linalg.norm(want)
            worst = max(worst, float(gap) if np.isfinite(gap) else float("inf"))
        return {"logits_rel_l2": {"value": worst}}

    def work(self, k: int) -> list:
        log = []
        self._reference(k, log=log)
        return log


class Control:
    """The reference in the program's place, with float8 e4m3 operands."""

    def __init__(self, cfg, capacities, params, device):
        self.cfg, self.capacities, self.params, self.device = cfg, capacities, params, device

    def __call__(self, points: np.ndarray, out=None) -> np.ndarray:
        x = torch.from_numpy(points).to(self.device)
        with torch.no_grad():
            return ref.forward(self.cfg, self.capacities, self.params, x,
                               q=fp8).cpu().numpy()

    def overflow(self, points: np.ndarray) -> int:
        x = torch.from_numpy(points).to(self.device)
        return sum(c.overflow for c, _ in ref.build_scales(self.cfg, self.capacities, x))


class StaleLogits(Program):
    last = None

    def __call__(self, points, valid=None, out=None):
        logits = super().__call__(points, valid)     # a new array, not ``out``
        stale = self.last if self.last is not None else np.zeros_like(logits)
        self.last = logits
        return stale


class HalfCloud(Program):
    def __call__(self, points, valid=None, out=None):
        valid = np.ones(points.shape[0], dtype=bool)
        valid[points.shape[0] // 2:] = False
        return super().__call__(points, valid, out)


class NoBatchNorm(Program):
    def __init__(self, cfg, capacities, params, device):
        from hplflownet_tpu_torch.models.splatnet import BN_EPS, PointBatchNorm
        super().__init__(cfg, capacities, params, device)
        with torch.no_grad():
            for m in self.model.modules():
                if isinstance(m, PointBatchNorm):
                    m.gamma.fill_(1.0)
                    m.beta.zero_()
                    m.mean.zero_()
                    m.var.fill_(1.0 - BN_EPS)


CONTROL = Control
FAULTS = {"stale_logits": StaleLogits, "half_cloud": HalfCloud, "no_bn": NoBatchNorm}
