"""Palette trainers (k-means)."""
