"""Host time of an output boundary's NaN watchdog, ms: the program's span
``run_loop.watchdog`` (``io.check_cfl``), its mean over the window's
boundaries.  None where the program keeps no such span."""


def read(rec):
    try:
        from scythe_tpu_torch import trace
    except ImportError:
        return None
    mean = trace.last_run().mean("run_loop.watchdog")
    return 1e3 * mean if mean is not None else None
