"""The whole step's share of the card's peak, %: the step's dense FLOPs
(``yardsticks.step_flops``: transforms and column solve, elementwise work
0) times the traced steps, over the traced window's wall time and the
published peak of the cell's precision."""

from benchmark import yardsticks as ys


def read(rec):
    if not rec.window_s or not rec.steps_traced:
        return None
    rate = ys.step_flops(rec.shape) * rec.steps_traced / rec.window_s
    return 100.0 * rate / ys.STEP_PEAK_FLOP_PER_S[rec.dtype_name]
