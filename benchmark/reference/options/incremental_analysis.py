"""``options["incremental_analysis"]``: the step closes with ``spec + A(var_np1
- S spec)`` in place of ``A(var_np1)`` (``scythe_tpu_torch/model.py``'s
step), so only the step's increment passes through the analysis.  The delta
is taken against the synthesis value itself, not the fields the equation
set overrode, so that ``A(S spec) = spec`` cancels.
"""

from __future__ import annotations

STAGE = "analysis"
ORDER = 0


def build(model, grid, ctx, dtype):
    def close(state, fields, var_np1):
        return state.spec + grid.analysis(var_np1 - fields["val"])

    return close
