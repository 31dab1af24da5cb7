"""Partition specs for parameters, batches and caches over a grid of
ranks (the counterpart of ``repro/sharding``)."""

from repro_torch.sharding.rules import (ShardingPolicy, batch_sharding_specs,
                                        cache_specs, for_grid,
                                        grad_sync_axes_for_grid, labels_spec,
                                        local_shard, logits_spec,
                                        param_sharding_tree, spec_for_param)

__all__ = ["ShardingPolicy", "batch_sharding_specs", "cache_specs",
           "for_grid", "grad_sync_axes_for_grid", "labels_spec",
           "local_shard", "logits_spec", "param_sharding_tree",
           "spec_for_param"]
