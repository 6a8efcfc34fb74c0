"""Colour science, distances, resize, output modes and the CUDA assign kernel."""
