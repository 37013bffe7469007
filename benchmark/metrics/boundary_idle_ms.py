"""The card's idle at an output boundary, ms, on the card's own clock: the
program's counter ``boundary_idle_s`` (CUDA events, from the end of one
interval's last replay to the next interval's first work), its mean over
the window's interior boundaries.  None where the program keeps no such
counter."""


def read(rec):
    try:
        from scythe_tpu_torch import trace
    except ImportError:
        return None
    mean = trace.last_run().mean("boundary_idle_s")
    return 1e3 * mean if mean is not None else None
