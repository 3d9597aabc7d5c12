"""Particle graphs: radius-graph edges and the graph dataset."""
