"""Nothing the benchmark runs loads JAX or the JAX package.

Module names are compared by their top-level name, whole:
``hplflownet_tpu_torch`` begins with ``hplflownet_tpu`` but is not it.
"""

import os
import shutil
import subprocess
import sys

from flowbench.run import FORBIDDEN

from ._util import ROOT, run_cell

REHEARSAL = {"FLOWBENCH_CPU_REHEARSAL": "1"}


def _top(names):
    return {n.split(".")[0] for n in names}


def test_reference_imports_neither_jax_nor_the_program():
    code = ("import sys, flowbench.reference.lattice, flowbench.reference.model, "
            "flowbench.reference.train, flowbench.work; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    loaded = set(r.stdout.split())
    assert "torch" in loaded and "flowbench" in loaded
    assert not loaded & (set(FORBIDDEN) | {"hplflownet_tpu_torch"}), loaded


def test_a_run_imports_no_jax_in_any_process():
    # PYTHONPROFILEIMPORTTIME reaches every interpreter the run starts
    r = run_cell(["--workload", "shallow-fwd-8k", "--seed", "2147483659",
                  "--seconds", "1", "--trace", "1"],
                 dict(REHEARSAL, PYTHONPROFILEIMPORTTIME="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    names = [line.rsplit("|", 1)[1].strip() for line in r.stderr.splitlines()
             if line.startswith("import time:") and "|" in line]
    loaded = _top(names)
    assert {"torch", "flowbench", "hplflownet_tpu_torch"} <= loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_a_loaded_jax_module_withholds_the_result(monkeypatch, capsys):
    import types

    from flowbench import run
    monkeypatch.setenv("FLOWBENCH_CPU_REHEARSAL", "1")
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "shallow-fwd-8k", "--seed", "3", "--seconds", "0.5"])
    out = capsys.readouterr()
    assert rc == 3
    assert out.out == ""
    assert "jax" in out.err


def test_no_card_no_result():
    env = dict(os.environ)
    env.pop("FLOWBENCH_CPU_REHEARSAL", None)
    r = run_cell(["--workload", "flagship-fwd-8k", "--seed", "1", "--seconds", "1"],
                 {"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "flowbench", tmp_path / "flowbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run_cell(["--workload", "shallow-fwd-8k", "--seed", "1", "--seconds", "1"],
                 REHEARSAL, cwd=tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "missing" in r.stderr
