"""chip_smoke.py's fused_build phase (20), rehearsed on the CPU.

At test_torch_chip_smoke_large.py's small size (the flagship at 128
points, small capacities, one torch thread), with the plain versions: the
tables of the flagship and shallow pyramids under HPL_FUSED_BUILD "1" and
a threshold against "0", the flagship flow and one step's gradients, the
batched forward against per-sample ones, and tools.fused_build_bench in
its own interpreter (the shallow model, one rep), so that a chip run does
not fail on a Python error.  Launch counts stay 0 on the CPU.
"""

import os

import chip_smoke
from hplflownet_tpu_torch.models import HPLFlowNet

try:
    from test_torch_chip_smoke_large import small_cpu_smoke  # noqa: F401
except ImportError:          # run as ``python -m pytest`` from elsewhere
    from tests.test_torch_chip_smoke_large import small_cpu_smoke  # noqa: F401


def test_fused_build_phase(small_cpu_smoke, monkeypatch):
    # the bench's interpreter takes one thread too
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(chip_smoke, "SHALLOW_CAPACITIES", [1024, 1024, 512, 256, 128])
    monkeypatch.setattr(chip_smoke, "FUSED_BUILD_REPS", 1)
    monkeypatch.setattr(chip_smoke, "FUSED_BUILD_ARCH", "HPLFlowNetShallow")
    # "1280" fuses the four coarse scales of the small capacities
    monkeypatch.setattr(chip_smoke, "FUSED_BUILD_MODES", ("1", "1280"))
    saved = os.environ.get("HPL_FUSED_BUILD")
    results = {}
    small_cpu_smoke.phase_fused_build(results)
    fb = results["fused_build"]
    # 7 + 5 scales of 18 fields and two splat plans of 6, under 2 modes
    assert fb["fields"] == 2 * 12 * (18 + 2 * 6)
    assert fb["leaves"] == len(list(HPLFlowNet(chip_smoke.SFM7, device="cpu")
                                    .parameters()))
    assert all(n == 0 for counts in fb["launches"].values()
               for n in counts.values())
    bench = fb["bench"]
    assert bench["arch"] == "HPLFlowNetShallow" and bench["points"] == 128
    assert bench["order"] == ["0", "1", "3584", "3584", "1", "0"]
    for k in ("build_ms", "forward_ms", "step_ms"):
        assert all(len(v) == 2 and min(v) > 0 for v in bench[k].values())
    assert bench["launches_forward"] == bench["launches_step"] == {
        "0": 0, "1": 0, "3584": 0}
    assert os.environ.get("HPL_FUSED_BUILD") == saved
