"""Box numerics, spatial encodings and multi-scale RoIAlign (plain and CUDA)."""
