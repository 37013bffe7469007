"""The frozen yardsticks against hand counts at the two cells' shapes."""

import math

import pytest

from benchmark import yardsticks as ys

TC = dict(geometry="RLZ", V=9, R=300, L=4, B=103, Z=24, semiimplicit=True)
CB = dict(geometry="RL", V=6, R=300, L=256, B=103, Z=0)


def einsum_flops(subs: str, sizes: dict) -> int:
    """2 x the product of every index's size: one multiply-add per term."""
    idx = set(subs.replace(",", "").replace("->", ""))
    return 2 * math.prod(sizes[i] for i in idx)


def grid_flops(s):
    """The einsums of the reference grid's synthesis and analysis, with
    their operands' sizes (d: the slots a stacked operator carries)."""
    sz = {"v": s["V"], "r": s["R"], "b": s["B"], "l": s["L"], "k": s["L"], "z": s["Z"],
          "K": s["Z"]}
    if s["geometry"] == "RL":
        syn = [("dlk,vbk->vdbl", 3), ("drb,vbl->vdrl", 3), ("rb,vdbl->vdrl", 2)]
        ana = [("kl,vrl->vrk", 1), ("vbr,vrk->vbk", 1)]
    else:
        syn = [("dzK,vbkK->vdbkz", 3), ("dlk,vbkz->vdblz", 3), ("lk,vdbkz->vdblz", 2),
               ("drb,vblz->vdrlz", 3), ("rb,vdblz->vdrlz", 2), ("rb,vdblz->vdrlz", 2)]
        ana = [("kl,vrlz->vrkz", 1), ("vbr,vrkz->vbkz", 1), ("vKz,vbkz->vbkK", 1)]
    total = 0
    for subs, d in syn + ana:
        total += einsum_flops(subs, {**sz, "d": d})
    return total


@pytest.mark.parametrize("shape", [TC, CB], ids=["tc", "cb"])
def test_step_flops_are_the_grids_einsums(shape):
    solve = 2 * shape["R"] * shape["L"] * (2 * shape["Z"]) ** 2 if shape.get("semiimplicit") else 0
    assert ys.step_flops(shape) == grid_flops(shape) + solve


def test_step_flops_by_hand():
    assert ys.step_flops(CB) == 1_048_485_888  # 6 vars: 256^2 DFTs, radial 300 x 103
    assert ys.step_flops(TC) == 455_410_944


def test_column_solve_bound_at_the_tc_shape():
    ms, by = ys.column_solve_bound(1200, 24, "float32")
    nbytes = (4 * 1200 * 24 + 4 * 24 * 24) * 4  # x*, w* in, w, xi out, M once
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert 2 * 1200 * 48**2 / 165e12 * 1e3 < ms


def test_analysis_bound_at_the_tc_shape():
    ms, by = ys.analysis_bound((9, 300, 4, 24), 103)
    words = 9 * 300 * 4 * 24 + 16 + 1200 + 9 * 103 * 300 + 9 * 576 + 9 * 103 * 4 * 24
    assert by == "bytes" and ms == pytest.approx(4 * words / 3.35e12 * 1e3, rel=1e-12)


@pytest.mark.parametrize("name, cls", [
    ("void (anonymous namespace)::column_solve_kernel<float>(float const*, float const*, uint4 "
     "const*, float*, float*, int, int)", "handwritten"),
    ("void (anonymous namespace)::rlz_analysis_kernel<float, 256>(float const*, float const*, "
     "float const*", "handwritten"),
    ("void getrf_kernelWarp<float, float, true>(cublasLuParams, float* const*)", "lu"),
    ("void batch_trsm_left_kernel<float, 64, 4, 3, false, false, false>(cublasTrsmBatchParams2"
     "<float>, float", "lu"),
    ("void laswp_kernel<float, false>(int, float* const*, int, int, int, int const*, int, int, "
     "int)", "lu"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_warpsize1x4x1_ffma_aligna4_"
     "alignc4_execute_kernel", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "std::array<char*, 3ul> >", "pointwise"),
    ("Memcpy DtoD (Device -> Device)", "pointwise"),
])
def test_kernel_names_fall_in_one_class(name, cls):
    assert ys.kernel_class(name) == cls
