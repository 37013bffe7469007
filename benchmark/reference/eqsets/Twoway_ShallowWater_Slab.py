"""Cha & Bell's two-way slab: the two-layer core with the boundary layer's
mass sink and source fed back to the free layer (``S1``)."""

from __future__ import annotations

from ..slab import slab_core

OPTIONS = frozenset()


def tendency(fields, ctx):
    return slab_core(fields, ctx, twoway=True)
