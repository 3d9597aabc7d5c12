"""Seeded inputs the benchmark makes on the device and hands to both the
program and the references: GNN weights, object states and targets.

Every function draws from a `torch.Generator` on the run's device, in a few
large calls, so the same seed gives the same inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """An independent generator for one use (``stream``) of a run's seed."""
    words = np.random.SeedSequence([int(seed) % 2**64, int(stream)]).generate_state(2, np.uint64)
    return torch.Generator(device=device).manual_seed(int(words[0] >> np.uint64(1)))


def input_dims(model: dict) -> tuple[int, int]:
    """(particle input width, relation input width) of the interaction
    network (gs-dynamics' `DynamicsPredictor`)."""
    n_his = model["n_his"]
    p = model["attr_dim"] + model["action_dim"]
    p += {0: 0, 1: n_his, 3: 3 * n_his}[model["state_dim"]]
    if model["motion_dim"] > 0:
        p += 3 * (n_his - 1)
    r = (2 * model["attr_dim"] if model["rel_attr_dim"] > 0 else 0)
    r += 1 if model["rel_group_dim"] > 0 else 0
    r += 3 * n_his if model["rel_distance_dim"] > 0 else 0
    return p, r


def gnn_shapes(model: dict) -> dict:
    """Every weight of the network in the port's state-dict layout:
    name -> (shape, fan_in); biases have fan_in 0."""
    nf = model["nf_effect"]
    p_in, r_in = input_dims(model)
    shapes = {}
    for name, dims in (("particle_encoder", (p_in, model["nf_particle"], nf, nf)),
                       ("relation_encoder", (r_in, model["nf_relation"], nf, nf)),
                       ("non_rigid_predictor", (nf, nf, nf, 3))):
        for i in range(3):
            shapes[f"{name}.dense.{i}.weight"] = ((dims[i + 1], dims[i]), dims[i])
            shapes[f"{name}.dense.{i}.bias"] = ((dims[i + 1],), 0)
    shapes["relation_propagator.kernel"] = ((3 * nf, nf), 3 * nf)
    shapes["relation_propagator.bias"] = ((nf,), 0)
    shapes["particle_propagator.kernel"] = ((2 * nf, nf), 2 * nf)
    shapes["particle_propagator.bias"] = ((nf,), 0)
    return shapes


def gnn_weights(model: dict, gen: torch.Generator, device, head_scale: float,
                bias_std: float = 0.01) -> dict:
    """Seeded weights: lecun-normal kernels truncated at two deviations,
    small random biases, the motion head's last layer scaled by
    ``head_scale`` so that a unit push moves particles by millimetres, as a
    trained model does. One draw for all of them, then views."""
    shapes = gnn_shapes(model)
    total = sum(math.prod(s) for s, _ in shapes.values())
    draw = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, (shape, fan_in) in shapes.items():
        n = math.prod(shape)
        std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978 if fan_in else bias_std
        if name.startswith("non_rigid_predictor.dense.2"):
            std *= head_scale
        out[name] = (draw[at:at + n] * std).view(shape)
        at += n
    return out


def rope_states(gen: torch.Generator, count: int, n: int, obj: dict, device):
    """``count`` ropes of ``n`` particles: a bent polyline of a seeded length
    (``obj["length_m"]`` range) whose heading takes a random walk and whose
    spacing varies by up to ``obj["spacing_jitter"]``, lying on the table
    (z within ``obj["z_noise_m"]``), centred at a seeded point of
    ``obj["centre_box_m"]``. Returns (count, n, 3)."""
    u = torch.rand(count, 4 + 2 * n, generator=gen, device=device)
    lo, hi = obj["length_m"]
    length = lo + (hi - lo) * u[:, 0:1]
    heading0 = 2 * math.pi * u[:, 1:2]
    turns = (u[:, 4:4 + n] - 0.5) * 2 * obj["turn_rad"]
    heading = heading0 + torch.cumsum(turns, 1)
    step = 1.0 + obj["spacing_jitter"] * (2 * u[:, 4 + n:4 + 2 * n] - 1)
    step = step / step[:, 1:].sum(1, keepdim=True) * length
    step[:, 0] = 0.0
    xy = torch.cumsum(torch.stack([step * torch.cos(heading),
                                   step * torch.sin(heading)], -1), 1)
    box = torch.tensor(obj["centre_box_m"], device=device)  # (2, 2) lo, hi
    centre = box[0] + (box[1] - box[0]) * u[:, 2:4]
    xy = xy - xy.mean(1, keepdim=True) + centre[:, None]
    z = obj["z_noise_m"] * (2 * torch.rand(count, n, 1, generator=gen, device=device) - 1)
    return torch.cat([xy, z], -1)


def cloth_states(gen: torch.Generator, count: int, n: int, obj: dict, device):
    """``count`` crumpled sheets of ``n`` particles: uniform points of a
    square of side ``obj["side_m"]``, rotated by a seeded angle, whose height
    is a sum of ``obj["bumps"]`` seeded Gaussian bumps of up to
    ``obj["bump_m"]``, centred at a seeded point of ``obj["centre_box_m"]``.
    Returns (count, n, 3)."""
    side = obj["side_m"]
    u = torch.rand(count, n, 2, generator=gen, device=device) - 0.5
    k = obj["bumps"]
    b = torch.rand(count, k, 4, generator=gen, device=device)
    c = torch.rand(count, 3, generator=gen, device=device)
    centres, width = b[:, :, :2] - 0.5, 0.1 + 0.2 * b[:, :, 2]
    height = obj["bump_m"] * (2 * b[:, :, 3] - 1)
    d2 = ((u[:, :, None] - centres[:, None]) ** 2).sum(-1)
    z = (height[:, None] * torch.exp(-d2 / (2 * width[:, None] ** 2))).sum(-1)
    ang = 2 * math.pi * c[:, 0]
    rot = torch.stack([torch.stack([torch.cos(ang), -torch.sin(ang)], -1),
                       torch.stack([torch.sin(ang), torch.cos(ang)], -1)], -2)
    xy = torch.einsum("bij,bnj->bni", rot, u * side)
    box = torch.tensor(obj["centre_box_m"], device=device)
    centre = box[0] + (box[1] - box[0]) * c[:, 1:3]
    return torch.cat([xy + centre[:, None], z[..., None]], -1)


OBJECTS = {"rope": rope_states, "cloth": cloth_states}


def target_pushes(gen: torch.Generator, states, obj: dict):
    """(count, 4) pushes [x, y, theta, length] that make each state's
    target: the pusher starts ``obj["push_start_m"]`` from the state's
    centroid in a seeded direction and pushes towards it for
    ``obj["push_length"]`` unit pushes."""
    count = states.shape[0]
    theta = (2 * torch.rand(count, generator=gen, device=states.device) - 1) * math.pi
    centre = states[:, :, :2].mean(1)
    start = centre + obj["push_start_m"] * torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    length = torch.full_like(theta, float(obj["push_length"]))
    return torch.cat([start, theta[:, None], length[:, None]], -1)


def look_at_ring(angles, centre, distance: float):
    """(C, 4, 4) OpenCV world-to-camera poses turned about the y axis by
    ``angles`` around ``centre``, each looking at it from ``distance``."""
    poses = []
    for ang in angles:
        co, si = math.cos(ang), math.sin(ang)
        rot = np.array([[co, 0, si], [0, 1, 0], [-si, 0, co]], np.float64)
        w2c = np.eye(4)
        w2c[:3, :3] = rot
        w2c[:3, 3] = rot @ (-np.asarray(centre, np.float64)) + np.array([0, 0, distance])
        poses.append(w2c)
    return np.stack(poses).astype(np.float32)


def scene_radius(w2c) -> float:
    """1.1 x the largest camera distance from the cameras' centroid."""
    centres = np.linalg.inv(np.asarray(w2c, np.float64))[:, :3, 3]
    return float(1.1 * np.max(np.linalg.norm(centres - centres.mean(0), axis=-1)))


def tracking_cloud(gen: torch.Generator, scene: dict, device):
    """The object's true (n, 7) [xyz, rgb, seg] cloud: points uniform in a
    cube of side ``scene["cube_m"]`` about ``scene["centre"]``, colours
    uniform in [0.2, 0.8], a ``scene["fg_share"]`` of them foreground; and
    the noisy cloud the tracking state starts from (positions off by
    ``scene["start_noise_m"]``)."""
    n = scene["points"]
    u = torch.rand(n, 7, generator=gen, device=device)
    xyz = (u[:, :3] - 0.5) * scene["cube_m"] + torch.tensor(scene["centre"], device=device)
    cloud = torch.cat([xyz, 0.2 + 0.6 * u[:, 3:6],
                       (u[:, 6:7] < scene["fg_share"]).float()], 1)
    noisy = cloud.clone()
    noisy[:, :3] += scene["start_noise_m"] * torch.randn(n, 3, generator=gen, device=device)
    return cloud, noisy


def tracking_frames(cloud, count: int, scene: dict):
    """``count`` true clouds, one a timestep: the object shifted along x by
    ``scene["step_m"]`` a timestep and turned about its centre's vertical
    axis by ``scene["turn_rad"]`` a timestep."""
    out = []
    centre = cloud[:, :3].mean(0)
    for t in range(count):
        a = scene["turn_rad"] * t
        co, si = math.cos(a), math.sin(a)
        rot = torch.tensor([[co, 0, si], [0, 1, 0], [-si, 0, co]], device=cloud.device)
        xyz = (cloud[:, :3] - centre) @ rot.T + centre
        xyz[:, 0] += scene["step_m"] * t
        out.append(torch.cat([xyz, cloud[:, 3:]], 1))
    return out


def pushed_episodes(gen: torch.Generator, count: int, frames: int, points: int, obj: dict,
                    ep: dict, device):
    """``count`` recorded pushes of ``frames`` frames each: a seeded object
    of ``points`` particles (`OBJECTS`) and one tool that starts
    ``obj["push_start_m"]`` from its centroid in a seeded direction and
    moves towards it ``ep["step_m"]`` a frame; each frame every particle
    moves with the tool's step, weighted by exp(-d^2 / 2 w^2) of its
    horizontal distance d to the tool (w = ``ep["reach_m"]``). Returns
    (positions (count, frames, points, 3), tool (count, frames, 1, 3))."""
    pos = OBJECTS[obj["kind"]](gen, count, points, obj, device)
    theta = (2 * torch.rand(count, generator=gen, device=device) - 1) * math.pi
    way = -torch.stack([torch.cos(theta), torch.sin(theta)], -1)  # towards the centre
    tool = pos[:, :, :2].mean(1) - obj["push_start_m"] * way
    step = ep["step_m"] * way
    z = pos[:, :, 2].min(1).values
    out_p, out_t = [], []
    for _ in range(frames):
        out_p.append(pos)
        out_t.append(torch.cat([tool, z[:, None]], -1)[:, None])
        d2 = ((pos[:, :, :2] - tool[:, None]) ** 2).sum(-1)
        w = torch.exp(-d2 / (2 * ep["reach_m"] ** 2))
        pos = pos + torch.cat([w[..., None] * step[:, None], torch.zeros_like(w)[..., None]], -1)
        tool = tool + step
    return torch.stack(out_p, 1), torch.stack(out_t, 1)
