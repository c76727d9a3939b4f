"""Box numerics, spatial encodings, losses, multi-scale RoIAlign (plain, CUDA, adjoint) and the
FrozenBatchNorm epilogue (plain, CUDA)."""
