"""MPPI/GD planning through the GNN dynamics model."""
