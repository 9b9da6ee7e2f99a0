"""Scenario sharding over ``torch.distributed`` (the counterpart of
``altro_tpu/parallel``): the 1-D batch mesh, the sharded solve and MPC step,
the process-group and spawning helpers, and the multi-card dry run
(``parallel/dryrun.py``)."""
from .sharding import (BATCH_AXIS, ScenarioMesh, ShardedMPCStep, launch,
                       make_scenario_mesh, process_group, run_compacted_steps,
                       run_sharded_mpc, sharded_mpc_step, sharded_solve)

__all__ = ["BATCH_AXIS", "ScenarioMesh", "ShardedMPCStep", "launch",
           "make_scenario_mesh", "process_group", "run_compacted_steps",
           "run_sharded_mpc", "sharded_mpc_step", "sharded_solve"]
