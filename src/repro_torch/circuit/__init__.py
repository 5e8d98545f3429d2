# Circuit simulation on the port: MNA assembly and the escalation ladder
# (numpy, the JAX package's copied), the Newton transient driver and its
# batched sweep over perturbed copies, and the AC small-signal sweep.
from .ladder import RUNGS, LadderConfig, RefactorizationLadder
from .mna import Circuit, rc_grid_circuit
from .simulate import (
    A_mul,
    ACSweepResult,
    TransientResult,
    TransientSweepResult,
    ac_sweep,
    perturbed_copies,
    transient,
    transient_sweep,
)

__all__ = [
    "Circuit",
    "rc_grid_circuit",
    "RUNGS",
    "LadderConfig",
    "RefactorizationLadder",
    "TransientResult",
    "TransientSweepResult",
    "A_mul",
    "ACSweepResult",
    "ac_sweep",
    "transient",
    "transient_sweep",
    "perturbed_copies",
]
