"""Particle graphs: radius-graph edges and (later) the graph dataset."""
