from .sharding import (DP_RULES, SERVE_RULES, TRAIN_RULES, Sharding,
                       ShardingRules, axes_to_spec, current_mesh,
                       current_rules, make_sharding, shard, shard_ctx,
                       spec_for_tree, spec_to_placements)
