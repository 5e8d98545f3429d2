# Scenario-sharded sweeps: the batch axis of the batched engine split over
# the cards of one host, driven by one process; and the explicit reductions
# (exact integer sums, int8-compressed gradient sums).
from .collectives import (
    compressed_psum,
    dequantize_int8,
    fake_quantize_grads,
    psum_exact,
    quantize_int8,
)
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
    "compressed_psum",
    "dequantize_int8",
    "fake_quantize_grads",
    "gather_rows",
    "make_scenario_sharding",
    "make_sweep_mesh",
    "map_blocks",
    "psum_exact",
    "quantize_int8",
]
