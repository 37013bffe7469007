"""Host time of an output boundary's write, ms: the program's span
``run_loop.write`` (``io.write_output``, and ``write_spectral`` where the
configuration asks for it), its mean over the window's boundaries.  None
where the program keeps no such span."""


def read(rec):
    try:
        from scythe_tpu_torch import trace
    except ImportError:
        return None
    mean = trace.last_run().mean("run_loop.write")
    return 1e3 * mean if mean is not None else None
