"""Nodes the equation set's tendency (its hooks included) adds to the
captured steady step's CUDA graph: the program's counter
``graph.nodes.tendency``, counted at the capture.  The capture is in
set-up, so the counter is the process's.  None where the program keeps no
such counter."""


def read(rec):
    try:
        from scythe_tpu_torch import trace
    except ImportError:
        return None
    return trace.process().total("graph.nodes.tendency")
