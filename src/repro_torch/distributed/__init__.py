"""Merges across splits of a computation (the KV-split decode combine)."""
