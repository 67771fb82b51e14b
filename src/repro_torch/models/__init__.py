"""The dense decoder over a paged KV cache."""
