"""gsdx_torch.io (config, checkpoint) and gsdx_torch.dynamics against gsdx.

The trained rope weights committed under benchmarks/out/ are the real
inputs; random inits cover the cloth/dog/sloth layout.
"""

import glob
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from gsdx.dynamics import losses as jlosses
from gsdx.dynamics.model import DynamicsPredictor as JModel
from gsdx.dynamics.model import ModelConfig as JModelConfig
from gsdx.dynamics.train import TrainConfig as JTrainConfig
from gsdx.dynamics.train import init_params
from gsdx.graph.dataset import GraphDatasetConfig as JDataConfig
from gsdx.io.config import load_config as j_load_config
from gsdx_torch.dynamics import losses as tlosses
from gsdx_torch.dynamics.model import (DynamicsPredictor, ModelConfig,
                                       flax_params, load_flax_params,
                                       params_from_flax)
from gsdx_torch.io import checkpoint as tckpt
from gsdx_torch.io.config import load_config, parse_yaml

REPO = os.path.join(os.path.dirname(__file__), "..")

# The tier runs six pytest-xdist workers, and each collects (imports) every
# test module, so this holds for the whole run. torch's default of one
# intra-op thread per core oversubscribed the cores six-fold: with it the
# port's tests took twice the wall time, with no gain in what they check.
torch.set_num_threads(min(2, torch.get_num_threads()))

CKPT =os.path.join(REPO, "benchmarks/out/generalization/checkpoints/latest.ckpt")
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))
                 + glob.glob(os.path.join(REPO, "configs", "*", "*.yaml")))


def trained_tree():
    with open(CKPT, "rb") as f:
        return flax.serialization.msgpack_restore(f.read())


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_reader_equals_safe_load(path):
    with open(path) as f:
        text = f.read()
    assert parse_yaml(text) == yaml.safe_load(text)


def test_yaml_reader_scalars_and_refusals():
    text = ("a: 1e-3\nb: 1.0e-3\nc: .5\nd: [1, 'x y', \"z\", 2.5, no]\n"
            "e:\nf: ~\ng: 'it''s'  # comment\nh:\n  - 1\n  - k: v\n    l: [ ]\n")
    assert parse_yaml(text) == yaml.safe_load(text)
    for bad in ("a: {b: 1}\n", "a: 'open\n", "a: 1\n  b: 2\n", "a: &x 1\n"):
        with pytest.raises(ValueError):
            parse_yaml(bad)


@pytest.mark.parametrize("name", ["rope", "cloth", "dog", "sloth"])
def test_typed_configs_equal_gsdx(name):
    path = os.path.join(REPO, "configs", f"{name}.yaml")
    for port, ref in zip(load_config(path), j_load_config(path)):
        assert type(port).__name__ == type(ref).__name__
        assert port._fields == ref._fields
        assert port._asdict() == ref._asdict()


# ---------------------------------------------------------------- checkpoint


def test_checkpoint_reader_equals_flax_bit_for_bit():
    port = tckpt.load_checkpoint(CKPT)
    ref = trained_tree()
    leaves_p = jax.tree_util.tree_leaves_with_path(port)
    leaves_r = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in leaves_p] == [p for p, _ in leaves_r]
    assert len(leaves_r) == 22
    for (path, a), (_, b) in zip(leaves_p, leaves_r):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def test_checkpoint_writer_round_trips_through_flax(tmp_path):
    tree = {"t": np.asarray(7, np.int32), "s": np.float32(1.5), "py": 3,
            "neg": -70000, "f": 0.25, "flag": True, "none": None, "name": "rope",
            "params": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                       "i": np.arange(5, dtype=np.int64),
                       "u": np.frombuffer(b"\x01\x02\xff", np.uint8),
                       "empty": np.zeros((0, 3), np.float32)},
            "tensor": torch.arange(4, dtype=torch.float32)}
    path = str(tmp_path / "c.ckpt")
    tckpt.save_checkpoint(path, tree)
    with open(path, "rb") as f:
        data = f.read()
    back = flax.serialization.msgpack_restore(data)
    assert back["name"] == "rope" and back["py"] == 3 and back["neg"] == -70000
    assert back["flag"] is True and back["none"] is None and back["f"] == 0.25
    assert back["s"] == np.float32(1.5) and back["t"].dtype == np.int32
    for k in ("w", "i", "u", "empty"):
        np.testing.assert_array_equal(back["params"][k], tree["params"][k])
        assert back["params"][k].dtype == tree["params"][k].dtype
    np.testing.assert_array_equal(back["tensor"], np.arange(4, dtype=np.float32))
    # and back through the port's reader, from flax's own bytes
    again = tckpt.msgpack_restore(flax.serialization.msgpack_serialize(back))
    np.testing.assert_array_equal(again["params"]["w"], tree["params"]["w"])
    # the committed checkpoint re-encodes to the same bytes
    with open(CKPT, "rb") as f:
        assert tckpt.msgpack_serialize(trained_tree()) == f.read()


def test_checkpoint_lifts_pre_r3_propagators(tmp_path):
    tree = trained_tree()
    old = jax.tree.map(lambda x: x, tree)
    for mod in ("relation_propagator", "particle_propagator"):
        old["params"][mod] = {"Dense_0": old["params"][mod]}
    path = str(tmp_path / "old.ckpt")
    with open(path, "wb") as f:
        f.write(flax.serialization.msgpack_serialize(old))
    model = DynamicsPredictor(ModelConfig())
    state = tckpt.load_checkpoint(path, target=flax_params(model))
    np.testing.assert_array_equal(state["params"]["relation_propagator"]["kernel"],
                                  tree["params"]["relation_propagator"]["kernel"])
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(path, target=flax_params(
            DynamicsPredictor(ModelConfig(nf_particle=64, nf_relation=64,
                                          nf_effect=64))))


# ---------------------------------------------------------------- model


def _graph_inputs(rng, cfg, B=2, n_p=30, nR=120):
    N = n_p + 1
    state = rng.normal(0, 0.05, (B, cfg.n_his, N, 3)).astype(np.float32)
    attrs = np.zeros((B, N, 2), np.float32)
    attrs[:, :n_p, 0] = 1
    attrs[:, n_p:, 1] = 1
    Rr = np.zeros((B, nR, N), np.float32)
    Rs = np.zeros((B, nR, N), np.float32)
    for b in range(B):
        for e in range(nR - 20):  # the last 20 slots stay empty
            Rr[b, e, rng.integers(N)] = 1
            Rs[b, e, rng.integers(N)] = 1
    p_inst = np.ones((B, n_p, 1), np.float32)
    action = np.zeros((B, N, 3), np.float32)
    action[:, n_p:] = rng.normal(0, 0.01, (B, 1, 3))
    return state, attrs, Rr, Rs, p_inst, action


def _jax_tree(cfg, seed=0):
    model = JModel(JModelConfig(**cfg._asdict()))
    dcfg = JDataConfig(n_his=cfg.n_his, max_nobj=20, max_tool=1, max_nR=80)
    return jax.tree.map(np.asarray, init_params(model, JTrainConfig(n_his=cfg.n_his),
                                                dcfg, jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("weights", ["trained_rope", "random_rope", "random_cloth"])
def test_model_matches_flax_apply(rng, weights):
    if weights == "trained_rope":
        cfg, tree = ModelConfig(), trained_tree()
    else:
        cfg = ModelConfig(state_dim=1, motion_dim=3) if weights == "random_cloth" \
            else ModelConfig()
        tree = _jax_tree(cfg)
    model = load_flax_params(DynamicsPredictor(cfg), tree)
    ins = _graph_inputs(rng, cfg)
    pred_j, motion_j = JModel(JModelConfig(**cfg._asdict())).apply(
        jax.tree.map(jnp.asarray, tree), *map(jnp.asarray, ins))
    with torch.no_grad():
        pred_t, motion_t = model(*map(torch.as_tensor, ins))
    # f32 products summed in another order (PARITY.md's 2e-5 class)
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(motion_t.numpy(), np.asarray(motion_j), atol=2e-5, rtol=0)


def test_weights_carry_both_ways(rng):
    tree = trained_tree()
    sd = params_from_flax(tree)
    # flax Dense kernels are (in, out); nn.Linear weights (out, in)
    assert sd["particle_encoder.dense.0.weight"].shape == (512, 5)
    assert sd["relation_propagator.kernel"].shape == (1536, 512)
    model = load_flax_params(DynamicsPredictor(ModelConfig()), tree)
    back = flax_params(model)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(tree)):
        assert a.tobytes() == b.tobytes(), path
    # a port init has flax's structure and shapes, and lecun-normal scale
    fresh = flax_params(DynamicsPredictor(ModelConfig(state_dim=1, motion_dim=3),
                                          generator=torch.Generator().manual_seed(0)))
    ref = _jax_tree(ModelConfig(state_dim=1, motion_dim=3))
    assert (jax.tree.map(np.shape, fresh) == jax.tree.map(np.shape, ref))
    k = fresh["params"]["relation_encoder"]["Dense_1"]["kernel"]
    assert abs(k.std() * np.sqrt(512) - 1) < 0.05
    assert not fresh["params"]["relation_encoder"]["Dense_1"]["bias"].any()


# ---------------------------------------------------------------- losses


def test_set_losses_match(rng):
    a = rng.normal(size=(2, 40, 3)).astype(np.float32)
    b = rng.normal(size=(2, 35, 3)).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    # f32 sums in another order
    np.testing.assert_allclose(tlosses._pairwise_dist(ta, tb).numpy(),
                               np.asarray(jlosses._pairwise_dist(a, b)), rtol=1e-5, atol=1e-6)
    for name in ("chamfer_distance", "hausdorff_distance", "emd_distance"):
        np.testing.assert_allclose(float(getattr(tlosses, name)(ta, tb)),
                                   float(getattr(jlosses, name)(a, b)), rtol=1e-5,
                                   err_msg=name)
    c = b[:, :40] if b.shape[1] >= 40 else rng.normal(size=(2, 40, 3)).astype(np.float32)
    assert tlosses.emd_distance_exact(ta, torch.as_tensor(c)) == pytest.approx(
        jlosses.emd_distance_exact(a, c), rel=1e-6)
