"""Operations and bytes that the work needs, from the configuration's
shapes, and the card's published peaks. Part of the yardstick: the counts
are the same whatever implements the work.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
"""

from __future__ import annotations

from perfbench.scenes import input_dims

PEAK_BF16_FLOP_S = 989e12
PEAK_BYTES_S = 3.35e12


def gnn_products(model: dict, n_nodes: int, n_rel: int, n_p: int) -> list[tuple]:
    """Every product of one GNN step as (rows, in, out): the interaction
    network with its loop-invariant encoder projections out of the message
    rounds (the least work that computes it)."""
    nf = model["nf_effect"]
    p_in, r_in = input_dims(model)
    out = [(n_nodes, p_in, model["nf_particle"]), (n_nodes, model["nf_particle"], nf),
           (n_nodes, nf, nf),
           (n_rel, r_in, model["nf_relation"]), (n_rel, model["nf_relation"], nf),
           (n_rel, nf, nf),
           (n_rel, nf, nf),  # relation propagator, the encoding's rows
           (n_nodes, nf, nf)]  # particle propagator, the encoding's rows
    for _ in range(model["pstep"]):
        out += [(n_nodes, nf, 2 * nf),  # receiver and sender effect projections
                (n_nodes, nf, nf)]  # particle propagator, the aggregate's rows
    out += [(n_p, nf, nf), (n_p, nf, nf), (n_p, nf, 3)]
    return out


def gnn_step_flops(model: dict, n_nodes: int, n_rel: int, n_p: int) -> int:
    """Operations of one GNN step of one sample: 2 a multiply-add of every
    product, and a message round's three adds an edge feature (receiver and
    sender projections onto the relation's, then the aggregation)."""
    macs = sum(r * i * o for r, i, o in gnn_products(model, n_nodes, n_rel, n_p))
    adds = model["pstep"] * 3 * n_rel * model["nf_effect"]
    return 2 * macs + adds


def gnn_step_bytes(model: dict, n_nodes: int, n_rel: int, n_p: int) -> int:
    """Bytes one GNN step of one sample must move: its f32 inputs (position
    history, attributes, action), its relations as two int32 indices, and its
    f32 predicted positions. The weights are read once for many samples and
    are left out, which can only lower the bound."""
    f4, i4 = 4, 4
    ins = n_nodes * (3 * model["n_his"] + model["attr_dim"] + model["action_dim"]) * f4
    return ins + 2 * n_rel * i4 + n_p * 3 * f4


def plan_shapes(config: dict) -> tuple[int, int, int]:
    """(nodes, relations, predicted particles) of a planning step at the
    configuration's published shapes."""
    d = config["dataset_config"]
    return d["max_nobj"] + d["max_tool"], d["max_nR"], d["max_nobj"]


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOP_S, nbytes / PEAK_BYTES_S)
