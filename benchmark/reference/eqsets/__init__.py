"""The reference's equation sets, one module a set (see ``equations.py``)."""
