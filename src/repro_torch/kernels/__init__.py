# Hand-written CUDA kernels for the card, each with its plain PyTorch twin.
# Nothing is compiled at import: the first launch builds csrc/ (see _build).
from . import ops, ref
from .dense_lu import dense_lu
from .level_update import segmented_accumulate

__all__ = ["ops", "ref", "dense_lu", "segmented_accumulate"]
