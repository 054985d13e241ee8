"""Launch layer: production meshes, cell specs, training and serving
drivers."""
