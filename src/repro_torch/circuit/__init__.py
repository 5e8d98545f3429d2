# Circuit simulation on the port: MNA assembly and the escalation ladder
# (numpy, the JAX package's copied), and the Newton transient driver.
from .ladder import RUNGS, LadderConfig, RefactorizationLadder
from .mna import Circuit, rc_grid_circuit
from .simulate import A_mul, TransientResult, transient

__all__ = [
    "Circuit",
    "rc_grid_circuit",
    "RUNGS",
    "LadderConfig",
    "RefactorizationLadder",
    "TransientResult",
    "A_mul",
    "transient",
]
