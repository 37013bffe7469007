"""The column solve's share of its bound, %: ``column_solve_bound`` at the
step's columns over the kernel's mean device time a launch."""

from benchmark import yardsticks as ys


def read(rec):
    mean_s = rec.kernel_mean_s("column_solve_kernel")
    if mean_s is None:
        return None
    s = rec.shape
    bound, _ = ys.column_solve_bound(s["R"] * s["L"], s["Z"], rec.dtype_name)
    return 100.0 * bound * 1e-3 / mean_s
