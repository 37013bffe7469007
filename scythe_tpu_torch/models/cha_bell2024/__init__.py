"""The Cha & Bell (2024) two-layer model configurations
(``models/cha_bell2024/*.py`` of the JAX package)."""
