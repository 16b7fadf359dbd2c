"""VGG feature stack, weights, and losses of the port."""
