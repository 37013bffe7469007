"""Nodes the equation set's del^4 refit (``MoistEulerSLZ``'s
``hyperdiffusion_k4``: a second analysis and synthesis of the horizontal
Laplacian, and its Laplacian again) adds to the captured steady step's CUDA
graph: the program's counter ``graph.nodes.hyperdiffusion``, counted at the
capture, outside ``graph.nodes.tendency``.  The capture is in set-up, so the
counter is the process's.  None where the program keeps no such counter: a
step without the refit, or a program whose stages do not nest."""


def read(rec):
    try:
        from scythe_tpu_torch import trace
    except ImportError:
        return None
    return trace.process().total("graph.nodes.hyperdiffusion")
