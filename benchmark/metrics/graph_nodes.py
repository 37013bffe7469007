"""Nodes of the captured steady step's CUDA graph (cuGraphGetNodes)."""


def read(rec):
    info = rec.graph_info
    return info["nodes"] if info else None
