"""Host time of an output boundary's fetch, ms: the program's span
``run_loop.fetch`` (the gather, the synthesis and the copy to the host),
its mean over the window's boundaries, the initial output included.  None
where the program keeps no such span."""


def read(rec):
    try:
        from scythe_tpu_torch import trace
    except ImportError:
        return None
    mean = trace.last_run().mean("run_loop.fetch")
    return 1e3 * mean if mean is not None else None
