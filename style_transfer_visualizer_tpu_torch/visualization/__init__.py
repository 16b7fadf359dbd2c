"""Loss-curve plotting."""
