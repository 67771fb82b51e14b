"""Training runtime: optimizer, checkpoints, the train loop (the port of `repro.runtime`)."""
