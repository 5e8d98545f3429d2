"""The paper's own benchmark configuration: matrix suite and solver knobs.

The JAX package's ``fuse_levels`` and ``use_pallas`` have no counterpart
here (every level is its own step, and the kernels are the default on the
card); ``device`` is the port's: ``None`` is the card.
"""
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GLUConfig:
    suite: str = "grid64"          # key into repro_torch.sparse.SUITES
    ordering: str = "auto"
    symbolic: str = "auto"
    dtype: str = "float64"
    panel_threshold: int = 16      # paper: stream mode engages at level size 16
    device: Optional[str] = None


CONFIG = GLUConfig()
