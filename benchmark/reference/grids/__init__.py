"""The reference's grids, one module a geometry (see ``grid.py``)."""
