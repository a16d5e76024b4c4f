"""redisearch_tpu_torch.analysis (host-side helpers)."""
