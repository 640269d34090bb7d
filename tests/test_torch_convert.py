"""amid_tpu_torch.convert: every flax leaf of an AMIDModel tree maps to
exactly one torch parameter, with its shape and values, and none is left
over on either side."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from amid_tpu.config import ModelConfig as JaxModelConfig
from amid_tpu.models.amid import build_model as jax_build_model
from amid_tpu_torch.config import ModelConfig
from amid_tpu_torch.convert import params_from_flax
from amid_tpu_torch.models.amid import build_model

KW = dict(backbone="sasrec", emb_dim=16, hid_dim=4, seq_len=6, batch_size=4,
          is_itc=True, ts2=0.4, is_dr=True, item_length=20, user_length=20,
          sasrec_heads=2)


def _flax_tree(**overrides):
    """The flax tree of a JAX AMIDModel, every leaf refilled with distinct
    random values so that a leaf can be found by its value."""
    cfg = JaxModelConfig(**{**KW, **overrides}, kernels="xla")
    b, t = cfg.batch_size, cfg.seq_len
    batch = {"seq_d1": jnp.zeros((b, t), jnp.int32), "seq_d2": jnp.zeros((b, t), jnp.int32),
             "target": jnp.zeros(b, jnp.int32), "neg_samples": jnp.zeros((b, 2), jnp.int32)}
    key = jax.random.PRNGKey(0)
    params = jax_build_model(cfg).init({"params": key, "dropout": key}, batch,
                                       train=False)["params"]
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), params)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _transform(path, x):
    if path.endswith("trans_bs_kernel"):
        return x[None, :]
    return x.T if path.endswith("kernel") else x


@pytest.mark.parametrize("overrides", [{}, {"is_inc": True}, {"is_dr": False},
                                       {"sasrec_blocks": 3},
                                       {"comp_broadcast_quirk": False},  # no kernel adds a leaf
                                       {"comp_broadcast_quirk": False, "is_inc": True}])
def test_every_leaf_maps_to_one_parameter(overrides):
    tree = _flax_tree(**overrides)
    sd = params_from_flax(tree)
    model = build_model(ModelConfig(**{**KW, **overrides}), device="cpu")
    assert set(sd) == set(model.state_dict())  # none left over on either side
    flat = dict(_leaves(tree))
    assert len(flat) == len(sd)
    by_value = {}
    for path, x in flat.items():
        want = _transform(path, x)
        hits = [name for name, t in sd.items()
                if tuple(t.shape) == want.shape and np.array_equal(t.numpy(), want)]
        assert len(hits) == 1, (path, hits)
        by_value[path] = hits[0]
    assert len(set(by_value.values())) == len(flat)
    for name, t in model.state_dict().items():
        assert sd[name].shape == t.shape, name
    model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("drop", [
    "item_embedding", "enc_d2/pos_emb", "enc_d1/attn_1/out_proj_bias",
    "enc_d2/ffn_0/conv2/kernel", "itc_d2/PeerMessage_0/trans_bs_bias",
    "predict_gfunc/fc2_kernel",
])
def test_missing_leaf_raises(drop):
    tree = _flax_tree()
    node = tree
    *parents, leaf = drop.split("/")
    for p in parents:
        node = node[p]
    del node[leaf]
    with pytest.raises(ValueError, match="lacks leaves"):
        params_from_flax(tree)


@pytest.mark.parametrize("extra", [("enc_d1", "gru"), ("predict", "fc3_kernel"),
                                   ("user_embedding", None)])
def test_left_over_leaf_raises(extra):
    tree = _flax_tree()
    parent, leaf = extra
    if leaf is None:
        tree[parent] = np.zeros((3, 16), np.float32)
    else:
        tree[parent][leaf] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError, match="no counterpart"):
        params_from_flax(tree)


def test_converted_tensors_are_independent_copies():
    tree = _flax_tree()
    sd = params_from_flax(tree)
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in sd.values())
    sd["item_embedding"].add_(1.0)
    assert not np.array_equal(sd["item_embedding"].numpy(), tree["item_embedding"])
