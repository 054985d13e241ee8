"""Launch layer: the serving driver."""
