"""Host time an output boundary waits for the previous output's write, ms:
the program's span ``run_loop.write_wait`` (the run loop's wait for its
background writer before it hands over the next write), its mean over the
window's boundaries, the initial output included.  Near 0 where a write is
shorter than an interval; above it the writer, not the card, sets the pace.
None where the program keeps no such span."""


def read(rec):
    try:
        from scythe_tpu_torch import trace
    except ImportError:
        return None
    mean = trace.last_run().mean("run_loop.write_wait")
    return 1e3 * mean if mean is not None else None
