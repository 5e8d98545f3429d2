"""A Newton-like iterate on a matrix's pattern, frozen copy of
``chip_smoke.newton_values``: off-diagonal entries move by up to 10 %,
diagonals grow by 10-20 %, so a diagonally dominant matrix stays so."""
import numpy as np

from portbench.matrix import Matrix


def perturb(A: Matrix, data: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """``data`` (A's values or another set on its pattern), moved once."""
    scale = np.where(A.diag_mask(), rng.uniform(1.1, 1.2, size=A.nnz),
                     rng.uniform(0.9, 1.1, size=A.nnz))
    return np.asarray(data) * scale
