"""The forward entry: ``pipeline.flow_forward`` on one pair per request.

A request hands in the pair's two (N, 3) float32 host arrays and ends when
the (N, 3) flow is a host array.  It failed if the flow is not finite, or
if the program's build of the pair drops a vertex or a point (its overflow
counters, read after the window).

``correct`` compares what the window served: a sample of finished
requests, drawn from the seed, against the reference's float32 flow of the
same pair and weights.  The number is the largest relative L2 gap
``||flow - ref|| / ||ref||`` over the sample (``flow_rel_l2``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import lattice as ref_lattice
from ..reference import model as ref_model
from ..reference.model import init_params

__all__ = ["init_params", "Program", "Session"]


class Program:
    """The measured program's forward."""

    def __init__(self, cfg, capacities, params, device):
        from hplflownet_tpu_torch.models import MODELS
        from hplflownet_tpu_torch.pipeline import make_lattice_spec
        self.device = device
        self.model = MODELS[cfg["arch"]](
            cfg["scales_filter_map"], dim=cfg["dim"], use_leaky=cfg["use_leaky"],
            bcn_use_bias=cfg["bcn_use_bias"], bcn_use_norm=cfg["bcn_use_norm"],
            last_relu=cfg["last_relu"], compute_dtype=cfg["compute_dtype"],
            device=device)
        self.model.load_state_dict(params, strict=True)
        self.spec = make_lattice_spec(cfg["scales_filter_map"], capacities)

    def __call__(self, pc1: np.ndarray, pc2: np.ndarray) -> np.ndarray:
        from hplflownet_tpu_torch.pipeline import flow_forward
        flow = flow_forward(self.model, self.spec, pc1, pc2, adjoint_plans=False)
        return flow.cpu().numpy()

    def overflow(self, pc1: np.ndarray, pc2: np.ndarray) -> int:
        """Vertices and points the program's build of the pair drops."""
        from hplflownet_tpu_torch.lattice.build import build_pyramid
        with torch.inference_mode():
            scales = build_pyramid(self.spec, torch.from_numpy(pc1).to(self.device),
                                   torch.from_numpy(pc2).to(self.device),
                                   adjoint_plans=False)
            total = sum(sp.pc1_overflow + sp.pc2_overflow + sp.probe_overflow
                        + sp.stencil_overflow for sp in scales)
            return int(total)


class Session:
    entry = "forward"

    def __init__(self, cfg, capacities, mix, pool, params, seed, device,
                 program=Program):
        self.cfg, self.capacities, self.mix = cfg, capacities, mix
        self.pool, self.params, self.seed, self.device = pool, params, seed, device
        self.program = program(cfg, capacities, params, device)
        self.served = []          # (pool index, host flow) per finished request

    def warm(self, order) -> None:
        """Three requests on the first pool pairs (every pair has the same
        shapes); ``order`` is left as it is."""
        for k in range(min(3, len(self.pool.pc1))):
            self.program(self.pool.pc1[k], self.pool.pc2[k])

    def call(self, k: int) -> bool:
        flow = self.program(self.pool.pc1[k], self.pool.pc2[k])
        self.served.append((k, flow))
        return bool(np.isfinite(flow).all())

    def overflowing(self) -> set:
        """Pool pairs whose build drops work (after the window)."""
        used = sorted({k for k, _ in self.served})
        return {k for k in used
                if self.program.overflow(self.pool.pc1[k], self.pool.pc2[k])}

    def release(self):
        self.program = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, k: int, log=None, q=None) -> torch.Tensor:
        dev = self.device
        pc1 = torch.from_numpy(self.pool.pc1[k]).to(dev)
        pc2 = torch.from_numpy(self.pool.pc2[k]).to(dev)
        with torch.no_grad():
            scales = ref_lattice.build_pyramid(self.cfg["scales_filter_map"],
                                               self.capacities, pc1, pc2)
            return ref_model.forward(self.cfg, self.params, pc1, pc2, scales,
                                     q=q, log=log)

    def check(self) -> dict:
        n = int(self.mix["check"]["requests"])
        rng = np.random.default_rng(np.random.SeedSequence([int(self.seed) % (1 << 64), 7]))
        picks = rng.choice(len(self.served), size=min(n, len(self.served)),
                           replace=False)
        worst = 0.0
        for i in sorted(int(j) for j in picks):
            k, flow = self.served[i]
            ref = self._reference(k).cpu().numpy().astype(np.float64)
            gap = np.linalg.norm(flow.astype(np.float64) - ref) / np.linalg.norm(ref)
            worst = max(worst, float(gap) if np.isfinite(gap) else float("inf"))
        return {"flow_rel_l2": {"value": worst}}

    def work(self, k: int) -> list:
        log = []
        self._reference(k, log=log)
        return log
