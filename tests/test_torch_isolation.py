"""The port and chip_smoke.py import nothing of JAX.

The card's machine has no jax, flax or optax, and importing any module of
hplflownet_tpu loads them; no module of the port may need yaml on
import either.  A subprocess installs a ``sys.meta_path``
finder that refuses those packages, then imports every module of
hplflownet_tpu_torch and chip_smoke.py (module import only).  A static
pass over the sources finds no import statement of those packages either,
in the tools subpackage or anywhere else in the port.
"""

import ast
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFUSING_IMPORTS = r'''
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "hplflownet_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import hplflownet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    hplflownet_tpu_torch.__path__, "hplflownet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
# yaml is needed only to read a config file (parse_args_from_yaml)
assert "yaml" not in sys.modules
print("imported", len(names), "modules:", " ".join(names))
'''


def _run(args, cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_and_chip_smoke_import_without_jax():
    r = _run(["-c", _REFUSING_IMPORTS], ROOT)
    assert r.returncode == 0, r.stderr
    n = int(r.stdout.split()[1])
    # every subpackage and module was walked, the later slices' too (79
    # since tools.op_profile went, 80 with kernels.dense, 81 with
    # models.splatnet, 82 with kernels.slice)
    assert n >= 82, r.stdout
    for mod in ("train.step", "train.schedule", "models.losses", "models.init",
                "models.hplflownet_shallow", "models.splatnet", "data", "data.io",
                "data.transforms",
                "data.datasets", "data.loader", "train.metrics",
                "train.geometry2d", "train.checkpoint", "train.driver", "utils",
                "utils.config", "utils.logging", "utils.profiling", "main",
                "kernels.dkernel", "kernels.tap_tables", "kernels.rank_fused",
                "kernels.take", "kernels.rank_partial", "kernels.stencil_plan",
                "kernels.dense", "kernels.slice",
                "ops.dispatch",
                "tools", "tools.timing", "tools.microbench", "tools.gather_lab",
                "tools.rank_partial_lab", "tools.rank_cases", "tools.tap_cases",
                "tools.step_calls", "tools.kernel_ab",
                "data.visualization", "data.preprocess",
                "data.preprocess.flyingthings3d", "data.preprocess.kitti",
                "parallel", "parallel.mesh", "parallel.distributed",
                "parallel.data_parallel", "bench", "tools.train_synthetic",
                "tools.eval_synthetic", "tools.dryrun_multiprocess",
                "ops.shard", "parallel.lattice_parallel", "native",
                "native.bindings", "native.check", "native.__main__",
                "tools.large_cloud_bench", "tools.measure_capacities",
                "tools.pyramid_bench",
                "tools.port_torch_weights", "tools.fused_build_bench"):
        assert f"hplflownet_tpu_torch.{mod}" in r.stdout.split(), mod


def test_no_port_source_imports_jax_or_the_jax_package():
    blocked = ("jax", "jaxlib", "flax", "optax", "hplflownet_tpu")
    pkg = os.path.join(ROOT, "hplflownet_tpu_torch")
    sources = [os.path.join(d, f) for d, _, fs in os.walk(pkg)
               if "_build" not in os.path.relpath(d, pkg).split(os.sep)
               for f in fs if f.endswith(".py")]
    assert any(os.sep + "tools" + os.sep in p for p in sources)
    for path in sources + [os.path.join(ROOT, "chip_smoke.py")]:
        with open(path) as fd:
            tree = ast.parse(fd.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in blocked, (path, m)


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    r = _run(["chip_smoke.py"], ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
