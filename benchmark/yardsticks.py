"""The benchmark's fixed yardsticks: the card's published peaks, the least
time a kernel could take (``bound_ms`` and the two kernels' bounds), the
dense FLOPs of a model step, the word lists that sort kernel names into
classes, and the count of a captured graph's nodes.

The peaks, ``bound_ms``, ``column_solve_bound``, ``analysis_bound``,
``graph_nodes`` and the GEMM word list are copies of ``chip_smoke.py``'s,
frozen here so that a later change to the program cannot move them.
"""

from __future__ import annotations

from benchmark.reference.grid import geometry_module

# NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {
    # products of f32 matrices to f32 accuracy on the tensor cores (3xTF32:
    # three TF32 products, so a third of 495 TFLOP/s): the column solve
    "f32 products": 495e12 / 3,
    "f64 products": 67e12,
    # f32 outside the tensor cores: the transforms' GEMMs with TF32 off
    "f32 elementwise": 67e12,
}
# the peak a whole step's share is taken of, by the cell's precision: float32
# with TF32 off runs its GEMMs on the CUDA cores; float64 on the f64 tensor
# cores
STEP_PEAK_FLOP_PER_S = {"float32": 67e12, "float64": 67e12}

# kernel classes, tried in this order; a name that matches none is pointwise
HANDWRITTEN_KERNEL_WORDS = ("column_solve_kernel", "column_solve_comp_kernel",
                            "rlz_analysis_kernel", "rlz_analysis_comp_kernel")
LU_KERNEL_WORDS = ("getrf", "getrs", "getri", "trsm", "trsv", "laswp", "pivot")
# what the library's matrix-product kernels (behind torch.einsum) are named
GEMM_KERNEL_WORDS = ("gemm", "gemv", "cutlass", "xmma", "splitk")
KERNEL_CLASSES = (("handwritten", HANDWRITTEN_KERNEL_WORDS), ("lu", LU_KERNEL_WORDS),
                  ("gemm", GEMM_KERNEL_WORDS))


def kernel_class(name: str) -> str:
    """"handwritten", "lu", "gemm" or "pointwise" (every other device op,
    the graph's copies among them) of a device op's name."""
    low = name.lower()
    for cls, words in KERNEL_CLASSES:
        if any(w in low for w in words):
            return cls
    return "pointwise"


def bound_ms(nbytes, flops, kind):
    """(ms, "bytes" | "operations"): the least time the card could take;
    ``kind`` is a key of PEAK_FLOP_PER_S."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def column_solve_bound(ncols, nz, dtype_name):
    """x*, w* and M read once, w and xi written once; 2 ncols (2nz)^2 FLOP."""
    f32 = dtype_name == "float32"
    return bound_ms((4 * ncols * nz + 4 * nz * nz) * (4 if f32 else 8),
                    2 * ncols * (2 * nz) ** 2, "f32 products" if f32 else "f64 products")


def analysis_bound(shape, b_rdim, f64=False):
    """The RLZ analysis of x [V, R, L, Z] to [V, b_rDim, L, Z] (f32, or f64):
    x, the DFT matrix, the ring mask and both operator stacks read once, the
    coefficients written once; the lambda (the kernel's dense l x l product,
    masked after), radial and vertical products."""
    V, R, L, Z = shape
    B = b_rdim
    return bound_ms(
        (8 if f64 else 4)
        * (V * R * L * Z + L * L + R * L + V * B * R + V * Z * Z + V * B * L * Z),
        2 * V * R * L * L * Z + 2 * V * B * R * L * Z + 2 * V * B * L * Z * Z,
        "f64 products" if f64 else "f32 products")


def step_flops(shape: dict) -> int:
    """Dense FLOPs of one model step: one synthesis, one analysis (counted by
    the reference grid's module of the geometry) and, where
    the step is semi-implicit, the column solve (2 ncols (2nz)^2).  The
    elementwise work counts 0, so the count does not depend on what
    implements the step."""
    g, V, R, L, B, Z = (shape[k] for k in ("geometry", "V", "R", "L", "B", "Z"))
    grid = geometry_module(g)
    flops = grid.synthesis_flops(V, R, L, B, Z) + grid.analysis_flops(V, R, L, B, Z)
    if shape.get("semiimplicit"):
        flops += 2 * R * L * (2 * Z) ** 2
    return flops


def graph_nodes(graph):
    """{"nodes": n, "kernel_nodes": k, ...} of a captured
    torch.cuda.CUDAGraph, read by libcuda's cuGraphGetNodes; None
    where this torch cannot hand out its cudaGraph_t."""
    import ctypes

    if not hasattr(graph, "raw_cuda_graph"):
        return None
    cu = ctypes.CDLL("libcuda.so.1")
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(g, None, ctypes.byref(n)) != 0:
        return None
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)) != 0:
        return None
    kinds = {}
    for node in nodes:
        t = ctypes.c_int()
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) != 0:
            return None
        # CUgraphNodeType: 0 kernel, 1 memcpy, 2 memset, 3 host, 4 graph, 5 empty
        name = {0: "kernel_nodes", 1: "memcpy_nodes", 2: "memset_nodes"}.get(
            t.value, f"type{t.value}_nodes")
        kinds[name] = kinds.get(name, 0) + 1
    return {"nodes": n.value, **kinds}
