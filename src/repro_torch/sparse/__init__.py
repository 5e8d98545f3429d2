from .csc import CSC, concat_ranges, csc_from_coo, csc_to_dense, csc_transpose_pattern, pattern_digest
from .layout import (
    ValueLayout,
    pabs,
    pack_planes,
    pdiv,
    pmul,
    resolve_layout,
    unpack_planes,
)
from .gen import (
    SUITES,
    ac_jacobian,
    asic_like,
    circuit_jacobian,
    grid_laplacian,
    ill_conditioned_jacobian,
    make_suite_matrix,
    multi_domain_circuit,
    rc_ladder,
)
from .io import read_matrix_market, write_matrix_market

__all__ = [
    "CSC",
    "concat_ranges",
    "csc_from_coo",
    "csc_to_dense",
    "csc_transpose_pattern",
    "pattern_digest",
    "SUITES",
    "ac_jacobian",
    "asic_like",
    "circuit_jacobian",
    "grid_laplacian",
    "ill_conditioned_jacobian",
    "make_suite_matrix",
    "multi_domain_circuit",
    "read_matrix_market",
    "write_matrix_market",
    "rc_ladder",
    "ValueLayout",
    "resolve_layout",
    "pack_planes",
    "unpack_planes",
    "pmul",
    "pdiv",
    "pabs",
]
