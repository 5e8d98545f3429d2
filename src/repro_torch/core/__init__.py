# GLU3.0 core in PyTorch: host planning (numpy, the JAX package's planner
# copied), level-scheduled numeric factorization and triangular solves.
from .api import GLU, resolve_value_dtype
from .dependency import (
    Levelization,
    dependencies_doubleu,
    dependencies_exact,
    dependencies_relaxed,
    dependencies_upattern,
    level_stats,
    levelize,
    levelize_relaxed,
    longest_path_levels,
)
from .factorize import (
    TorchFactorizer,
    factorize_numpy,
    factorize_numpy_fast,
    leftlooking_numpy,
    split_lu,
)
from .ordering import (
    fill_reducing_ordering,
    max_product_matching,
    minimum_degree,
    rcm,
    resolve_ordering_method,
    zero_free_diagonal,
)
from .plan import FactorizePlan, LevelSegment, build_plan
from .planner import (
    MC64Scaling,
    PlanCache,
    SymbolicPlan,
    build_symbolic_plan,
    compute_scaling,
    default_plan_cache,
    plan_factorization,
    plan_key,
)
from .symbolic import FilledPattern, resolve_symbolic_method, symbolic_fillin
from .triangular import TorchTriangularSolver, trisolve_numpy

__all__ = [
    "GLU",
    "resolve_value_dtype",
    "Levelization",
    "dependencies_doubleu",
    "dependencies_exact",
    "dependencies_relaxed",
    "dependencies_upattern",
    "level_stats",
    "levelize",
    "levelize_relaxed",
    "longest_path_levels",
    "TorchFactorizer",
    "factorize_numpy",
    "factorize_numpy_fast",
    "leftlooking_numpy",
    "split_lu",
    "fill_reducing_ordering",
    "max_product_matching",
    "minimum_degree",
    "rcm",
    "resolve_ordering_method",
    "zero_free_diagonal",
    "FactorizePlan",
    "LevelSegment",
    "build_plan",
    "MC64Scaling",
    "PlanCache",
    "SymbolicPlan",
    "build_symbolic_plan",
    "compute_scaling",
    "default_plan_cache",
    "plan_factorization",
    "plan_key",
    "FilledPattern",
    "resolve_symbolic_method",
    "symbolic_fillin",
    "TorchTriangularSolver",
    "trisolve_numpy",
]
