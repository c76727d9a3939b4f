"""Box numerics, spatial encodings, losses and multi-scale RoIAlign (plain, CUDA, adjoint)."""
