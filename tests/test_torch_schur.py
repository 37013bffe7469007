"""The port's Schur builders (scythe_tpu_torch.parallel.schur) are a copy of
the JAX package's numpy module: every field of SchurOps and PCROps, the
interface emulation and the sequential emulation of the distributed
analysis must be np.array_equal to the original's, at shard counts 2, 4
and 8, both interface solves and the BC pairs of tests/test_schur.py; bad
partitions raise the same errors."""

import numpy as np
import pytest

from scythe_tpu import GridParameters as JGridParameters
from scythe_tpu.parallel import schur as js
from scythe_tpu_torch import GridParameters as TGridParameters
from scythe_tpu_torch.basis.bspline import BC as TBC
from scythe_tpu_torch.parallel import schur as ts

BC_PAIRS = [("R0", "R0"), ("R1T0", "R1T1"), ("R2T10", "R1T0"), ("R3", "R0"),
            ("PERIODIC", "PERIODIC")]


def _params(num_cells, bcl, bcr, nvars=2):
    """tests/test_schur.py's configuration, as each package's parameters."""
    from scythe_tpu.basis.bspline import BC as JBC

    names = "uvwxyz"[:nvars]
    out = []
    for cls, bc in ((JGridParameters, JBC), (TGridParameters, TBC)):
        out.append(cls(
            geometry="R", xmin=-40.0, xmax=60.0, num_cells=num_cells,
            BCL={n: bc[bcl] for n in names}, BCR={n: bc[bcr] for n in names},
            vars={n: i + 1 for i, n in enumerate(names)},
        ))
    return out


def _assert_same(a, b):
    for name in a.__dataclass_fields__:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray):
            assert np.array_equal(x, y), name
        else:
            assert x == y, name


@pytest.mark.parametrize("bcl,bcr", BC_PAIRS)
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("interface", ["gather", "pcr"])
def test_schur_ops_array_equal(bcl, bcr, n, interface):
    pj, pt = _params(32, bcl, bcr)
    sj = js.build_schur_ops(pj, n, include_cs=interface == "gather")
    st = ts.build_schur_ops(pt, n, include_cs=interface == "gather")
    _assert_same(sj, st)
    pcr_j = js.build_pcr_ops(pj, n) if interface == "pcr" else None
    pcr_t = ts.build_pcr_ops(pt, n) if interface == "pcr" else None
    if pcr_j is not None:
        _assert_same(pcr_j, pcr_t)
    phys = np.random.default_rng(42).normal(size=(pj.nvars, pj.rDim, 3))
    assert np.array_equal(
        ts.numpy_sharded_analysis(pt, ts.build_schur_ops(pt, n), phys, pcr=pcr_t),
        js.numpy_sharded_analysis(pj, js.build_schur_ops(pj, n), phys, pcr=pcr_j),
    )
    if pcr_j is not None:
        g = np.random.default_rng(1).normal(size=(n, pj.nvars, 3, 2))
        assert np.array_equal(ts.numpy_pcr_interface(pcr_t, g),
                              js.numpy_pcr_interface(pcr_j, g))


def test_constants_and_interfaces_array_equal():
    assert ts.HALO == js.HALO
    pj, pt = _params(24, "R1T0", "R0", nvars=3)
    for (oj, *rj), (ot, *rt) in zip(js.var_interfaces(pj, 4), ts.var_interfaces(pt, 4)):
        for k in ("T", "mmat", "project", "analysis"):
            assert np.array_equal(getattr(oj, k), getattr(ot, k)), k
        seps_j, ints_j, spos_j, S_j = rj
        seps_t, ints_t, spos_t, S_t = rt
        assert all(np.array_equal(a, b) for a, b in zip(seps_j, seps_t))
        assert all(np.array_equal(a, b) for a, b in zip(ints_j, ints_t))
        assert spos_j == spos_t and np.array_equal(S_j, S_t)


@pytest.mark.parametrize("num_cells,n,bcl,bcr", [
    (10, 3, "R0", "R0"),  # not divisible
    (8, 4, "R0", "R0"),  # fewer than 4 cells a shard
    (8, 1, "R0", "R0"),  # one shard
])
def test_bad_partitions_raise_alike(num_cells, n, bcl, bcr):
    pj, pt = _params(num_cells, bcl, bcr)
    with pytest.raises(ValueError) as ej:
        js.build_schur_ops(pj, n)
    with pytest.raises(ValueError) as et:
        ts.build_schur_ops(pt, n)
    assert str(et.value) == str(ej.value)
