# The solver's own benchmark configuration (the JAX package's LM registry
# is not part of the port).
from .glu_paper import CONFIG, GLUConfig

__all__ = ["CONFIG", "GLUConfig"]
