"""The port's numpy operator builders (scythe_tpu_torch.basis) are copies of
the JAX package's: every operator must be np.array_equal to the original."""

import numpy as np
import pytest
import torch

from scythe_tpu.basis import bspline as jb
from scythe_tpu.basis import chebyshev as jc
from scythe_tpu.basis import fourier as jf
from scythe_tpu_torch.basis import bspline as tb
from scythe_tpu_torch.basis import chebyshev as tc
from scythe_tpu_torch.basis import fourier as tf

torch.set_num_threads(2)

_OPEN = [b.name for b in jb.BC if b != jb.BC.PERIODIC]
BC_PAIRS = [(l, r) for l in _OPEN for r in ("R0", "R1T0", "R1T1", "R3")] + [
    ("PERIODIC", "PERIODIC")
]


def _assert_fields_equal(a, b, names):
    for name in names:
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("bcl,bcr", BC_PAIRS)
@pytest.mark.parametrize("num_cells", [4, 9])
def test_bspline_ops_array_equal(bcl, bcr, num_cells):
    args = (-3.0, 17.0, num_cells)
    j = jb.build_ops(*args, jb.BC[bcl], jb.BC[bcr], 2.0)
    t = tb.build_ops(*args, tb.BC[bcl], tb.BC[bcr], 2.0)
    _assert_fields_equal(
        t, j,
        ("mish", "weights", "project", "msolve", "analysis", "synth", "T", "mmat"),
    )
    assert np.array_equal(
        tb.constraint_matrix(num_cells, tb.BC[bcl], tb.BC[bcr]),
        jb.constraint_matrix(num_cells, jb.BC[bcl], jb.BC[bcr]),
    )


def test_bspline_constants_and_enum():
    assert tb.MUBAR == jb.MUBAR
    assert [b.value for b in tb.BC] == [b.value for b in jb.BC]
    x = np.linspace(0.0, 1.0, 11)
    for d in range(4):
        assert np.array_equal(
            tb.collocation_matrix(0.0, 1.0, 5, x, d),
            jb.collocation_matrix(0.0, 1.0, 5, x, d),
        )


@pytest.mark.parametrize("nz", [5, 16, 24, 40, 48, 100])
@pytest.mark.parametrize("bcb,bct", [("R0", "R0"), ("R1T0", "R1T1"), ("R1T1", "R0"),
                                     ("R0", "R1T0")])
def test_chebyshev_ops_array_equal(nz, bcb, bct):
    args = (nz, 0.0, 10000.0, jc.b_zdim(nz))
    j = jc.build_ops(*args, jc.ZBC[bcb], jc.ZBC[bct])
    t = tc.build_ops(*args, tc.ZBC[bcb], tc.ZBC[bct])
    _assert_fields_equal(
        t, j,
        ("points", "analysis", "constrain", "synth", "dsynth", "d2synth", "isynth",
         "dcoef"),
    )
    assert tc.b_zdim(nz) == jc.b_zdim(nz)
    assert np.array_equal(tc.dct_matrix(nz), jc.dct_matrix(nz))
    assert np.array_equal(tc.dct_1st_derivative(nz, 2.5e3), jc.dct_1st_derivative(nz, 2.5e3))
    assert np.array_equal(tc.dct_2nd_derivative(nz, 2.5e3), jc.dct_2nd_derivative(nz, 2.5e3))


@pytest.mark.parametrize("nl", [8, 16, 30, 64])
def test_fourier_ops_array_equal(nl):
    for a, b in zip(tf.dft_matrices(nl), jf.dft_matrices(nl)):
        assert np.array_equal(a, b)
    assert np.array_equal(tf.coeff_wavenumbers(nl), jf.coeff_wavenumbers(nl))
    assert np.array_equal(tf.angles(nl), jf.angles(nl))
    r = tb.mish_points(0.0, 20000.0, 12)
    assert np.array_equal(
        tf.ring_coeff_mask(r, 20000.0 / 12, nl, 2.0),
        jf.ring_coeff_mask(r, 20000.0 / 12, nl, 2.0),
    )
    assert np.array_equal(tf.ring_kmax(r, 20000.0 / 12, nl), jf.ring_kmax(r, 20000.0 / 12, nl))


@pytest.mark.parametrize("num_cells,requested", [(8, 0), (48, 64), (100, 256), (30, 0)])
def test_fourier_default_nl_equal(num_cells, requested):
    assert tf.default_nl(num_cells, requested) == jf.default_nl(num_cells, requested)
