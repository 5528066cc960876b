"""The port's host lattice builder (``hplflownet_tpu_torch.native``) on the CPU.

The three checks of tests/test_native.py (:26, :58, :85), each against the
port's torch builder and against the JAX package's ``HostLatticeBuilder``
(its committed library) on the same keys: dense ids, unique keys and
neighbour tables; correlation tables; overflow past capacity.  Then the
build's failures (no g++, a source g++ refuses) raise at once with the
compiler's output, and ``python -m hplflownet_tpu_torch.native --device
cpu`` agrees with the device builder.  Skips without g++.
"""

import shutil

import numpy as np
import pytest
import torch

from hplflownet_tpu.native.bindings import HostLatticeBuilder as JaxHostBuilder
from hplflownet_tpu_torch.lattice.build import (_build_from_elevated,
                                                _corr_tables, _neighbor_table,
                                                _unpack_keys)
from hplflownet_tpu_torch.lattice.geometry import elevate, simplex_from_elevated
from hplflownet_tpu_torch.lattice.offsets import neighborhood_offsets
from hplflownet_tpu_torch.native import bindings, check
from hplflownet_tpu_torch.native.bindings import HostLatticeBuilder, pack_keys_i64


@pytest.fixture(autouse=True)
def needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the host builder is compiled at first use")


def random_cloud(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3) * 3.0).astype(np.float32)


def _device_cloud(pts, cap):
    """The port's torch builder at scale 1.0, and the keys it used."""
    t = torch.from_numpy(pts)
    el = elevate(t, 1.0)
    cl = _build_from_elevated(el, torch.ones(len(pts), dtype=torch.bool), cap)
    return cl, simplex_from_elevated(el).keys


def test_native_matches_torch_builder_and_jax_host_builder():
    pts = random_cloud(256, seed=1)
    cap = 1500
    cl, keys = _device_cloud(pts, cap)
    hb = HostLatticeBuilder(d=3)
    unique, ids, total = hb.build_cloud(keys, cap)

    assert total == int(cl.num_valid)
    assert torch.equal(ids, cl.lattice_offset)
    jk = _unpack_keys(cl.vkeys, 3, 10)[:total]
    assert torch.equal(pack_keys_i64(jk, 3), unique[:total])
    offs = neighborhood_offsets(1, 3)
    nb = hb.neighbor_table(unique, total, offs)
    assert torch.equal(nb, _neighbor_table(cl, offs, 3))

    ju, jids, jtotal = JaxHostBuilder(d=3).build_cloud(keys.numpy(), cap)
    assert jtotal == total
    np.testing.assert_array_equal(unique.numpy(), ju)
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(
        nb.numpy(), JaxHostBuilder(d=3).neighbor_table(ju, jtotal, offs))


def test_native_corr_tables_match_torch_builder_and_jax_host_builder():
    pts1, pts2 = random_cloud(128, 2), random_cloud(128, 3)
    cap = 800
    cl1, k1 = _device_cloud(pts1, cap)
    cl2, k2 = _device_cloud(pts2, cap)
    hb = HostLatticeBuilder(d=3)
    u1, _, n1 = hb.build_cloud(k1, cap)
    u2, _, n2 = hb.build_cloud(k2, cap)
    offs = neighborhood_offsets(1, 3)
    pc1c, pc2c = hb.corr_tables(u1, n1, u2, n2, offs, offs)
    j1, j2u, j2inv, _ = _corr_tables(cl1, cl2, offs, offs, 3)
    assert torch.equal(pc1c, j1)
    assert torch.equal(pc2c, j2u[j2inv.long()])          # dense (F, Cc, H)

    jhb = JaxHostBuilder(d=3)
    ju1, _, jn1 = jhb.build_cloud(k1.numpy(), cap)
    ju2, _, jn2 = jhb.build_cloud(k2.numpy(), cap)
    jp1, jp2 = jhb.corr_tables(ju1, jn1, ju2, jn2, offs, offs)
    np.testing.assert_array_equal(pc1c.numpy(), jp1)
    np.testing.assert_array_equal(pc2c.numpy(), jp2)


def test_native_overflow_semantics():
    pts = random_cloud(128, seed=4)
    cl, keys = _device_cloud(pts, 32)
    unique, ids, total = HostLatticeBuilder(d=3).build_cloud(keys, 32)
    assert total > 32          # overflowed
    assert ids.max() < 32
    assert (ids == -1).any()   # dropped vertices yield -1
    assert torch.equal(ids, cl.lattice_offset)
    assert total - 32 == int(cl.overflow)
    _, jids, jtotal = JaxHostBuilder(d=3).build_cloud(keys.numpy(), 32)
    assert jtotal == total
    np.testing.assert_array_equal(ids.numpy(), jids)


def test_build_failures_raise_at_once(monkeypatch, tmp_path):
    monkeypatch.setattr(bindings, "_LIBS", {})
    monkeypatch.setattr(bindings.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        HostLatticeBuilder()
    monkeypatch.undo()

    bad = tmp_path / "lattice_builder.cpp"
    bad.write_text("extern \"C\" int broken( { return 0; }\n")
    monkeypatch.setattr(bindings, "_LIBS", {})
    monkeypatch.setattr(bindings, "SOURCE", bad)
    monkeypatch.setattr(bindings, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        bindings.load_library()
    assert "error" in str(err.value)          # the compiler's own message
    assert not list((tmp_path / "_build").glob("*.so"))


def test_cli_agrees_with_the_device_builder(capsys):
    res = check.main(["--device", "cpu", "--points", "512"])
    assert res["num_valid"][0] > 512 and res["capacity"] == 2048
    assert all(res["equal"]["pc1"].values()) and res["equal"]["corr_pc2"]
    assert set(res["host_ms"]) == {"build_cloud", "neighbor_table", "corr_tables"}
    assert '"tool": "native"' in capsys.readouterr().out
