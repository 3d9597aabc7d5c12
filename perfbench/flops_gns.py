"""Operations that a GNS forward needs, from the configuration's
widths and a sample's real nodes and edges (counts are linear in both, so
a window's totals give its work). Part of the yardstick: the counts are the
same whatever implements the work.

The least work: every MLP's products, the edge MLP's first layer taking
the receiver's and sender's columns on the node rows before their
selection (the gather of a product is the product of a gather), and a
block's three adds an edge feature (the two projected endpoints onto the
edge's own, then the receiver sum). LayerNorm, ReLU and the residuals are
not counted.
"""

from __future__ import annotations


def node_input_width(model: dict) -> int:
    d = model["dim"]
    width = (model["n_his"] - 1) * d + 2 * d
    return width + (model["type_embedding"] if model["particle_types"] > 1 else 0)


def products(model: dict, nodes: int, edges: int) -> list[tuple]:
    """Every product of a forward as (rows, in, out)."""
    L, H, d = model["latent_size"], model["hidden_layers"], model["dim"]

    def mlp(rows, fan_in, out):
        sizes = [fan_in] + [L] * H + [out]
        return [(rows, a, b) for a, b in zip(sizes[:-1], sizes[1:])]

    out = mlp(nodes, node_input_width(model), L) + mlp(edges, d + 1, L)
    for _ in range(model["message_passing_steps"]):
        out += [(nodes, L, 2 * L)]  # the receiver's and sender's columns, node-side
        out += [(edges, L, L)] + mlp(edges, L, L)[1:]  # the edge's columns, then the rest
        out += mlp(nodes, 2 * L, L)
    return out + mlp(nodes, L, d)


def forward_flops(model: dict, nodes: int, edges: int) -> int:
    """2 a multiply-add of every product, and a block's three adds an edge
    feature."""
    macs = sum(r * i * o for r, i, o in products(model, nodes, edges))
    return 2 * macs + model["message_passing_steps"] * 3 * edges * model["latent_size"]

