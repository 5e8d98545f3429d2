# Scenario-sharded sweeps: the batch axis of the batched engine split over
# the cards of one host, driven by one process.
from .collectives import psum_exact
from .scenario import (
    DEFAULT_RULES,
    ScenarioSharding,
    ShardedBatch,
    SweepMesh,
    batch_blocks,
    check_mesh,
    gather_rows,
    make_scenario_sharding,
    make_sweep_mesh,
    map_blocks,
)

__all__ = [
    "DEFAULT_RULES",
    "ScenarioSharding",
    "ShardedBatch",
    "SweepMesh",
    "batch_blocks",
    "check_mesh",
    "gather_rows",
    "make_scenario_sharding",
    "make_sweep_mesh",
    "map_blocks",
    "psum_exact",
]
