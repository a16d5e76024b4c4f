"""redisearch_tpu_torch.utils (host-side helpers)."""
