"""redisearch_tpu_torch.agg — batched FT.AGGREGATE on the device."""
