"""GLU3.0 sparse LU refactorize-and-solve in PyTorch, with hand-written CUDA
kernels for Hopper.  The JAX package ``repro`` is the reference it is held
against; this package imports nothing of it."""
from .core import GLU
from .convert import plan_from_arrays, plan_to_arrays, symbolic_plan_from_arrays

__all__ = ["GLU", "plan_from_arrays", "plan_to_arrays",
           "symbolic_plan_from_arrays"]
