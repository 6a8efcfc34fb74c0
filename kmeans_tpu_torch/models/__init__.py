"""Palette trainers: k-means (on the device) and the host palette
algorithms octree, median cut and Wu."""
