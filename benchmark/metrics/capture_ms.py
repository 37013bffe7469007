"""Host time of the steady step's capture, ms: the program's span
``graph.capture`` (the warm-up step, the capture and the instantiation),
its total over the process, in set-up.  None where the program keeps no
such span."""


def read(rec):
    try:
        from scythe_tpu_torch import trace
    except ImportError:
        return None
    total = trace.process().total("graph.capture")
    return 1e3 * total if total is not None else None
