"""redisearch_tpu_torch.aux — auxiliary services (FT.HYBRID)."""
