"""Several independent problems in one step (the multi-style batch)."""
