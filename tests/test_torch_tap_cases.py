"""The edge cases of ``hplflownet_tpu_torch.tools.tap_cases`` for
``stencil_tap_tables_sum`` (kernel 4).

Each case is checked for the property it is named for.  On the CPU the
wrapper runs its plain version, which is held in float32 against a numpy
float64 reference on every case and against the JAX package's kernel in
interpret mode, as ``tests/test_pallas_stencil.py:133`` runs it, where C is
a multiple of 128 (what the TPU kernel takes): at atol 1e-5 + rtol 1e-6,
since both sum in float32 in tap order.  The ``cuda``-marked test in
``tests/test_torch_kernels.py`` runs the same cases through the CUDA kernel
on a card.
"""

import jax
import numpy as np
import pytest
import torch

from hplflownet_tpu.ops.pallas_stencil import stencil_tap_tables_sum as pallas_tts
from hplflownet_tpu_torch.kernels.tap_tables import stencil_tap_tables_sum
from hplflownet_tpu_torch.tools.tap_cases import tap_cases

NAMES = ["absent_single", "c384", "corr_c64", "c36", "c3"]
TOL = dict(atol=1e-5, rtol=1e-6)


@pytest.fixture(scope="module")
def cases():
    return {c.name: c for c in tap_cases()}


def _property(case):
    f, h_out = case.nb.shape
    present = (case.nb >= 0).sum(0)
    assert case.tables.shape == (case.tables.shape[0], f * case.c)
    assert h_out % 8 and h_out % 32                   # ragged vertex blocks
    if case.name == "absent_single":
        assert (present[:10] == 0).all() and (present[10:20] == 1).all()
    elif case.name == "c384":
        assert case.c == 3 * 128
    elif case.name == "corr_c64":
        assert (f, case.c) == (65, 64)
    elif case.name == "c36":
        assert case.c % 8 and (case.c * 2) % 16        # no 16-byte bf16 rows
    elif case.name == "c3":
        assert case.c == 3


def _numpy_taps(case):
    f, h_out = case.nb.shape
    c = case.c
    out = np.zeros((h_out, c))
    for k in range(f):
        ids = case.nb[k]
        ok = ids >= 0
        out[ok] += case.tables[ids[ok], k * c:(k + 1) * c]
    return out


def test_the_cases_span_the_widths_and_taps(cases):
    assert list(cases) == NAMES
    assert {c.c for c in cases.values()} == {3, 36, 64, 128, 384}
    assert sum(c.c % 128 == 0 for c in cases.values()) == 2


@pytest.mark.parametrize("name", NAMES)
def test_tap_edge_case_plain_matches_numpy_and_jax(name, cases):
    case = cases[name]
    _property(case)
    got = stencil_tap_tables_sum(torch.from_numpy(case.tables), case.c,
                                 torch.from_numpy(case.nb))
    assert got.dtype == torch.float32
    assert got.shape == (case.nb.shape[1], case.c)
    np.testing.assert_allclose(got.numpy(), _numpy_taps(case), **TOL)
    if name == "absent_single":
        assert not got[:10].any()
    if case.c % 128 == 0:
        want = np.asarray(jax.jit(lambda t, n: pallas_tts(
            t, case.c, n, group=4, interpret=True))(case.tables, case.nb))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
