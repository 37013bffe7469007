"""The RLZ analysis kernel's share of its bound, %: ``analysis_bound`` at
the grid's shape over the kernel's mean device time a launch."""

from benchmark import yardsticks as ys


def read(rec):
    mean_s = rec.kernel_mean_s("rlz_analysis_kernel")
    if mean_s is None:
        return None
    s = rec.shape
    bound, _ = ys.analysis_bound((s["V"], s["R"], s["L"], s["Z"]), s["B"],
                                 f64=rec.dtype_name == "float64")
    return 100.0 * bound * 1e-3 / mean_s
