"""Dataset-side geometry: the point rotation and the 4D rollout's
trajectories, warps and point ops."""
