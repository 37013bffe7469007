"""Model configurations for the CLI (``python -m scythe_tpu_torch
<config.py>``): the port's copies of the JAX package's ``models/*.py``.  Each
file is executable configuration that defines ``model =
ModelParameters(...)`` from ``scythe_tpu_torch``."""
