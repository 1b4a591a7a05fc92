"""Parameter specs of the LM substrate (the serving half of the
reference's ``parallel`` package)."""
from .sharding import (ParamSpec, LOGICAL_RULES, init_params, stack_specs,
                       shard_act, count_params, map_specs)

__all__ = ["ParamSpec", "LOGICAL_RULES", "init_params", "stack_specs",
           "shard_act", "count_params", "map_specs"]
