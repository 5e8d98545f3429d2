# Hand-written CUDA kernels for the card, each with its plain PyTorch twin.
# Nothing is compiled at import: the first launch builds csrc/ (see _build).
from . import ops, ref
from .dense_lu import dense_lu, dense_lu_planar
from .level_update import LevelRun, level_run, segmented_accumulate

# every kernel wrapper that counts its launches (``launches``, ``captured``)
COUNTED = (level_run, dense_lu, dense_lu_planar)

__all__ = ["ops", "ref", "dense_lu", "dense_lu_planar", "LevelRun",
           "level_run", "segmented_accumulate", "COUNTED"]
