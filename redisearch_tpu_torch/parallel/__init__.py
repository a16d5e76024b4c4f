"""redisearch_tpu_torch.parallel — counterpart of redisearch_tpu/parallel/__init__.py: distributed execution over device slots."""
