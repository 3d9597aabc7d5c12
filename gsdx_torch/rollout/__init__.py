"""GNN rollout over a Gaussian scene and the skinning of its Gaussians."""
