"""Cha & Bell's one-way slab: the two-layer core with no feedback from the
boundary layer to the free layer (their symmetric spin-up runs it)."""

from __future__ import annotations

from ..slab import slab_core

OPTIONS = frozenset()


def tendency(fields, ctx):
    return slab_core(fields, ctx, twoway=False)
