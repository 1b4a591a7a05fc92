"""Logical-axis parameter specs and their mesh placements (the port of
the reference's ``parallel`` package)."""
from .sharding import (ParamSpec, LOGICAL_RULES, AbstractMesh,
                       mesh_axis_sizes, logical_to_pspec, param_pspecs,
                       prune_pspec, param_shardings, init_params,
                       abstract_params, stack_specs, shard_act,
                       activate_mesh, active_mesh, MeshGroups,
                       mesh_groups, shard_params, gather_params,
                       local_shape, count_params, map_specs)

__all__ = ["ParamSpec", "LOGICAL_RULES", "AbstractMesh", "mesh_axis_sizes",
           "logical_to_pspec", "param_pspecs", "prune_pspec",
           "param_shardings", "init_params", "abstract_params",
           "stack_specs", "shard_act", "activate_mesh", "active_mesh",
           "MeshGroups", "mesh_groups", "shard_params", "gather_params",
           "local_shape", "count_params", "map_specs"]
