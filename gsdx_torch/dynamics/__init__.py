"""GNN dynamics model, its losses and (later) its training."""
