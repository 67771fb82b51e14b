"""The paged serving engine and its KV cache."""
