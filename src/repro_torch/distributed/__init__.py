# Scenario-sharded sweeps: the batch axis of the batched engine split over
# the cards of one host, driven by one process; the explicit reductions
# (exact integer sums, int8-compressed gradient sums); and the
# logical-axis sharding rules of the dry run.
from .collectives import (
    compressed_psum,
    dequantize_int8,
    fake_quantize_grads,
    psum_exact,
    quantize_int8,
)
from .scenario import (
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
from .sharding import (
    DEFAULT_RULES,
    MeshShape,
    MeshSharding,
    axis_env,
    distribute_batch,
    distribute_model,
    logical_constraint,
    make_rules,
    param_shardings,
    sharding_for_spec,
    spec_struct,
    tree_shardings,
)

__all__ = [
    "DEFAULT_RULES",
    "MeshShape",
    "MeshSharding",
    "ScenarioSharding",
    "ShardedBatch",
    "SweepMesh",
    "axis_env",
    "batch_blocks",
    "check_mesh",
    "compressed_psum",
    "dequantize_int8",
    "distribute_batch",
    "distribute_model",
    "fake_quantize_grads",
    "gather_rows",
    "logical_constraint",
    "make_rules",
    "make_scenario_sharding",
    "make_sweep_mesh",
    "map_blocks",
    "param_shardings",
    "psum_exact",
    "quantize_int8",
    "sharding_for_spec",
    "spec_struct",
    "tree_shardings",
]
