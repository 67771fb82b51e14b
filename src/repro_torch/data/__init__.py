"""Synthetic token data (the port of `repro.data`)."""
