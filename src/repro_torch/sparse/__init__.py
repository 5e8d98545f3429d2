from .csc import CSC, concat_ranges, csc_from_coo, csc_to_dense, csc_transpose_pattern, pattern_digest
from .gen import (
    SUITES,
    asic_like,
    circuit_jacobian,
    grid_laplacian,
    make_suite_matrix,
    rc_ladder,
)

__all__ = [
    "CSC",
    "concat_ranges",
    "csc_from_coo",
    "csc_to_dense",
    "csc_transpose_pattern",
    "pattern_digest",
    "SUITES",
    "asic_like",
    "circuit_jacobian",
    "grid_laplacian",
    "make_suite_matrix",
    "rc_ladder",
]
