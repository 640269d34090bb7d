"""The port's BERT4Rec and GRU4Rec backbones against the JAX package's, on
the CPU: the encoders alone, the whole AMIDModel (forward and the gradient of
every leaf) at each placement of InnerComp and InterComp, the serving entry
point and the converter's trees. Identical weights (moved by
`amid_tpu_torch.convert`) and identical inputs made from a numpy seed; fp32
on both sides, dropout off; tolerance atol 1e-5 / rtol 1e-4 (sums in another
order). The JAX side runs its XLA attention below T=64 and its Pallas kernel
(interpret mode) at T=64, as its own model picks."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from amid_tpu.config import ModelConfig as JaxModelConfig
from amid_tpu.models.amid import build_model as jax_build_model
from amid_tpu.models import encoders as jax_encoders
from amid_tpu.models.encoders import Bert4RecEncoder as JaxBert4RecEncoder
from amid_tpu.models.encoders import BertBlock as JaxBertBlock
from amid_tpu.models.encoders import GruEncoder as JaxGruEncoder
from amid_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from amid_tpu.serve import user_representations as jax_user_representations
from amid_tpu_torch.config import ModelConfig
from amid_tpu_torch.convert import convert_leaves, params_from_flax
from amid_tpu_torch.models.amid import build_model
from amid_tpu_torch.models.encoders import (
    Bert4RecEncoder,
    BertBlock,
    GruEncoder,
    key_padding_bias,
)
from amid_tpu_torch.ops.attention import attention_plain
from amid_tpu_torch.serve import user_representations

ATOL, RTOL = 1e-5, 1e-4
D, HEADS, FF, BLOCKS, B, VOCAB = 16, 4, 32, 2, 8, 50  # table of 2 * VOCAB = 100 rows


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, flax_params, prefix):
    """Loads a flax subtree into `module` through the converter's rules."""
    sd = convert_leaves({prefix: _np_tree(flax_params)})
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def _key_mask(rng, t):
    """Random keep/mask pattern with row 0 fully masked and row 1 fully kept."""
    mask = rng.random((B, t)) < 0.6
    mask[0], mask[1] = False, True
    return mask


@pytest.mark.parametrize("t,jax_kernels", [(8, "xla"), (64, "pallas")])
@pytest.mark.parametrize("what", ["block", "encoder"])
def test_bert_encoder_matches_jax(rng, what, t, jax_kernels):
    """A partly and a fully masked row among the keys."""
    x = rng.normal(size=(B, t, D)).astype(np.float32)
    mask = _key_mask(rng, t)
    if what == "block":
        jmod = JaxBertBlock(HEADS, FF, 0.1, jax_kernels)
    else:
        jmod = JaxBert4RecEncoder(BLOCKS, HEADS, FF, 0.1, jax_kernels)
    with pltpu.force_tpu_interpret_mode():
        params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask), True)
        want = np.asarray(jmod.apply(params, jnp.asarray(x), jnp.asarray(mask), True))
    params = params["params"]
    if what == "block":  # a block's leaves, as they sit in a tower: enc_d1/block_0/...
        port = _load(Bert4RecEncoder(D, 1, HEADS, FF, 0.1, "torch"), {"block_0": params},
                     "enc_d1")
        assert isinstance(port.block[0], BertBlock)
        run = lambda x_, m_: port.block[0](x_, key_padding_bias(m_))  # noqa: E731
    else:
        port = _load(Bert4RecEncoder(D, BLOCKS, HEADS, FF, 0.1, "torch"), params, "enc_d1")
        run = port
    with torch.no_grad():
        got = run(torch.as_tensor(x), torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_gru_encoder_matches_jax(rng):
    t, hidden = 9, 12  # the hidden width differs from the input's
    x = rng.normal(size=(B, t, D)).astype(np.float32)
    jmod = JaxGruEncoder(hidden)
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    port = _load(GruEncoder(D, hidden), params, "enc_d1")
    assert tuple(port.gru.w_ih.shape) == (D, 3 * hidden)  # the JAX package's layout
    with torch.no_grad():
        got = port(torch.as_tensor(x)).numpy()
    assert got.shape == (B, t, hidden)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_gru_init_is_torch_s_bound(rng):
    gru = GruEncoder(D, 64).gru
    gru.reset_parameters(torch.Generator().manual_seed(0))
    for w in (gru.w_ih, gru.w_hh, gru.b_ih, gru.b_hh):
        assert w.abs().max() <= 1 / 8 and w.abs().max() > 0.1


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

MODEL_KW = dict(emb_dim=D, hid_dim=8, batch_size=B, ts1=0.12, ts2=0.12, is_dr=True,
                item_length=VOCAB, user_length=VOCAB, bert_blocks=BLOCKS, bert_heads=HEADS,
                bert_ff_dim=FF, bert_dropout=0.0)


def _batch(rng, t, zero_rows=True):
    """Ids over the whole table; user 0's d2 history is all id 0, so the
    BERT key mask (`seq_d2 > 0`) masks every key of both its towers, and
    user 1's d1 history too (its tower-1 mask without the quirk)."""
    hi = 2 * VOCAB
    batch = {
        "seq_d1": rng.integers(1, hi, (B, t)).astype(np.int32),
        "seq_d2": rng.integers(0, hi, (B, t)).astype(np.int32),
        "target": rng.integers(0, hi, B).astype(np.int32),
        "neg_samples": rng.integers(0, hi, (B, 3)).astype(np.int32),
    }
    if zero_rows:
        batch["seq_d2"][0] = 0
        batch["seq_d1"][1] = 0
    return batch


def jax_and_port(rng, seq_len, jax_kernels="xla", **overrides):
    """A JAX AMIDModel and its port with the same weights, and a batch."""
    jcfg = JaxModelConfig(**{**MODEL_KW, **overrides}, seq_len=seq_len, kernels=jax_kernels)
    jmodel = jax_build_model(jcfg)
    batch = _batch(rng, seq_len)
    key = jax.random.PRNGKey(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with pltpu.force_tpu_interpret_mode():
        params = jmodel.init({"params": key, "dropout": key}, jb, train=False)["params"]
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ModelConfig)
                         if f.name != "kernels"})
    port = build_model(cfg, device="cpu")
    port.load_state_dict(params_from_flax(_np_tree(params)), strict=True)
    return jmodel, params, port, batch


OUT_KEYS = ("u_d1", "u_d2", "logits_d1", "logits_d2", "ips_d1", "ips_d2", "gfunc_d1",
            "gfunc_d2")

PLACEMENTS = [(False, False), (True, False), (False, True), (True, True)]
# (backbone, InC, ItC, bert_d2_mask_quirk, seq_len, the smallest T the JAX
# model sends to its Pallas attention: 1 = every T, None = its own 64)
CASES = ([("gru4rec", inc, itc, True, 6, None) for inc, itc in PLACEMENTS]
         + [("bert4rec", inc, itc, quirk, 6, 1) for inc, itc in PLACEMENTS
            for quirk in (True, False)]
         + [("bert4rec", False, True, True, 32, None)])  # the encoder sees T=64


@pytest.mark.parametrize("backbone,inc,itc,quirk,seq_len,pallas_min_t", CASES)
def test_model_forward_and_every_gradient_match_jax(rng, monkeypatch, backbone, inc, itc,
                                                    quirk, seq_len, pallas_min_t):
    """Outputs, then the gradient of a weighted sum of every output with
    respect to every leaf (the item table included), with fully masked rows
    in the batch. BERT4Rec's gradients are held against the JAX package's
    Pallas route (`pallas_min_t`: the threshold lowered in the test, the JAX
    package untouched), whose additive mask the port follows: through a
    fully masked row the XLA route's replaced scores pass no gradient to q
    and k, the additive bias does (`test_additive_mask_...` below). The
    forward is held against the XLA route as well."""
    if pallas_min_t is not None:
        monkeypatch.setattr(jax_encoders, "PALLAS_ATTN_MIN_T", pallas_min_t)
    kw = dict(backbone=backbone, is_inc=inc, is_itc=itc, bert_d2_mask_quirk=quirk)
    jmodel, params, port, batch = jax_and_port(rng, seq_len, "pallas", **kw)
    weights = {k: rng.normal(size=(B, 4 if k.startswith(("logits", "ips", "gfunc")) else D))
               .astype(np.float32) for k in OUT_KEYS}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        out = jmodel.apply({"params": p}, jb, train=False)
        return sum(jnp.sum(out[k] * weights[k]) for k in OUT_KEYS), out

    with pltpu.force_tpu_interpret_mode():
        (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    xla = jax_build_model(JaxModelConfig(**{**MODEL_KW, **kw}, seq_len=seq_len,
                                         kernels="xla")).apply({"params": params}, jb,
                                                               train=False)
    out = port(batch)
    assert set(out) == set(OUT_KEYS)
    for k in OUT_KEYS:
        for route in (want, xla):
            np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(route[k]),
                                       atol=ATOL, rtol=RTOL, err_msg=k)
    loss = sum((out[k] * torch.as_tensor(weights[k])).sum() for k in OUT_KEYS)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in port.named_parameters()],
                                allow_unused=True)
    want_grads = params_from_flax(_np_tree(jgrads))
    assert set(names) == set(want_grads)
    for name, g in zip(names, grads):
        g = torch.zeros_like(want_grads[name]) if g is None else g
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_bert_key_masks_tile_whole_rows(rng):
    """InnerComp and InterComp lay time out as [seq ; message]: the mask
    repeats the whole row (jnp.tile), it does not interleave."""
    _, _, port, batch = jax_and_port(rng, 4, backbone="bert4rec", is_inc=True, is_itc=True,
                                     bert_d2_mask_quirk=False)
    m1, m2 = port._bert_key_masks(batch, 16, torch.device("cpu"))
    want1 = np.tile(batch["seq_d1"] > 0, (1, 4))
    want2 = np.tile(batch["seq_d2"] > 0, (1, 4))
    np.testing.assert_array_equal(m1.numpy(), want1)
    np.testing.assert_array_equal(m2.numpy(), want2)
    port.cfg.bert_d2_mask_quirk = True
    m1, _ = port._bert_key_masks(batch, 16, torch.device("cpu"))
    np.testing.assert_array_equal(m1.numpy(), want2)


@pytest.mark.parametrize("backbone", ["bert4rec", "gru4rec"])
def test_user_representations_match_the_jax_serving_entry(rng, backbone):
    _, params, port, batch = jax_and_port(rng, 6, backbone=backbone, is_itc=True)
    jmodel = jax_build_model(JaxModelConfig(**MODEL_KW, backbone=backbone, is_itc=True,
                                            seq_len=6, kernels="xla"))
    seqs = {k: batch[k] for k in ("seq_d1", "seq_d2")}
    want = jax_user_representations(jmodel, params, {k: jnp.asarray(v) for k, v in seqs.items()})
    got = user_representations(port, seqs)
    for g, w in zip(got, want):
        assert g.shape == (B, D)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# the additive key mask against the replaced one
# ---------------------------------------------------------------------------

def test_additive_mask_parts_from_the_replaced_mask_where_scores_exceed_32(rng):
    """The port adds -1e9 to a masked score, as the JAX package's Pallas
    route does; its XLA route replaces the score by -1e9. fp32 spaces
    numbers near 1e9 by 64, so the two agree while |score| < 32 (the tests'
    weights) and part on a fully masked row whose scores are larger: there
    the additive route keeps their differences in multiples of 64 and the
    replaced route is uniform."""
    t, heads, d = 64, 2, 16
    mask = _key_mask(rng, t)  # row 0 fully masked

    def routes(scale):
        q, k, v = (rng.normal(size=(B, t, d)).astype(np.float32) * s
                   for s in (scale, scale, 1.0))
        bias = key_padding_bias(torch.as_tensor(mask))
        port = attention_plain(*map(torch.as_tensor, (q, k, v)), bias, 0, heads, 0.0).numpy()
        with pltpu.force_tpu_interpret_mode():
            pallas = np.asarray(jax_fused_attention(
                *map(jnp.asarray, (q, k, v)), jnp.asarray(bias.numpy()),
                jnp.zeros((1,), jnp.int32), heads, 0.0))
        # the XLA route (amid_tpu/models/encoders.py::BertBlock): scores replaced
        split = lambda x: x.reshape(B, t, heads, d // heads).transpose(0, 2, 1, 3)  # noqa: E731
        s = np.einsum("bhqd,bhkd->bhqk", split(q), split(k)) / np.sqrt(d // heads)
        s = np.where(mask[:, None, None, :], s, np.float32(-1e9)).astype(np.float32)
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        xla = np.einsum("bhqk,bhkd->bhqd", p, split(v)).transpose(0, 2, 1, 3).reshape(B, t, d)
        return port, pallas, xla

    port, pallas, xla = routes(1.0)  # scores well under 32: all three agree
    np.testing.assert_allclose(port, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(port, xla, atol=ATOL, rtol=RTOL)
    port, pallas, xla = routes(12.0)  # scores in the hundreds
    np.testing.assert_allclose(port, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(port[1:], xla[1:], atol=1e-4, rtol=1e-4)  # partly masked rows agree
    assert np.abs(port[0] - xla[0]).max() > 0.1  # the fully masked row parts
    np.testing.assert_allclose(xla[0], np.broadcast_to(xla[0].mean(0), xla[0].shape),
                               atol=1e-5)  # replaced: every query averages v uniformly


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------

def _flax_tree(**overrides):
    """The flax tree of a JAX AMIDModel, every leaf refilled with distinct
    random values so that a leaf can be found by its value."""
    cfg = JaxModelConfig(**{**MODEL_KW, "seq_len": 6, "is_itc": True, **overrides},
                         kernels="xla")
    b, t = cfg.batch_size, cfg.seq_len
    batch = {"seq_d1": jnp.zeros((b, t), jnp.int32), "seq_d2": jnp.zeros((b, t), jnp.int32),
             "target": jnp.zeros(b, jnp.int32), "neg_samples": jnp.zeros((b, 2), jnp.int32)}
    key = jax.random.PRNGKey(0)
    params = jax_build_model(cfg).init({"params": key, "dropout": key}, batch,
                                       train=False)["params"]
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), params)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("overrides", [
    {"backbone": "bert4rec"}, {"backbone": "bert4rec", "bert_blocks": 3, "is_inc": True},
    {"backbone": "gru4rec"}, {"backbone": "gru4rec", "is_inc": True, "is_dr": False},
])
def test_every_leaf_of_a_bert_or_gru_tree_maps_to_one_parameter(overrides):
    tree = _flax_tree(**overrides)
    sd = params_from_flax(tree)
    model = build_model(ModelConfig(**{**MODEL_KW, "seq_len": 6, "is_itc": True, **overrides}),
                        device="cpu")
    assert set(sd) == set(model.state_dict())
    flat = dict(_leaves(tree))
    assert len(flat) == len(sd)
    for path, x in flat.items():
        if path.endswith("trans_bs_kernel"):
            want = x[None, :]
        else:  # the GRU's tensors keep their layout
            want = x.T if path.endswith("kernel") and "/gru/" not in path else x
        hits = [n for n, t in sd.items()
                if tuple(t.shape) == want.shape and np.array_equal(t.numpy(), want)]
        assert len(hits) == 1, (path, hits)
    model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("backbone,drop", [
    ("bert4rec", "enc_d1/block_1/ff2/kernel"), ("bert4rec", "enc_d2/block_0/ln1/scale"),
    ("bert4rec", "enc_d2/block_1/k/bias"), ("gru4rec", "enc_d2/gru/b_hh"),
    ("gru4rec", "enc_d1/gru/w_ih"),
])
def test_a_bert_or_gru_tree_missing_a_leaf_raises(backbone, drop):
    tree = _flax_tree(backbone=backbone)
    node = tree
    *parents, leaf = drop.split("/")
    for p in parents:
        node = node[p]
    del node[leaf]
    with pytest.raises(ValueError, match="lacks leaves"):
        params_from_flax(tree)


@pytest.mark.parametrize("backbone,parent,leaf", [
    ("bert4rec", "enc_d1/block_0", "ln3"), ("bert4rec", "enc_d1/block_0/q", "scale"),
    ("gru4rec", "enc_d1/gru", "w_hr"), ("gru4rec", "enc_d2", "pos_emb"),
    ("bert4rec", "enc_d2", "gru"),
])
def test_a_bert_or_gru_tree_with_an_unknown_or_mixed_leaf_raises(backbone, parent, leaf):
    tree = _flax_tree(backbone=backbone)
    node = tree
    for p in parent.split("/"):
        node = node[p]
    node[leaf] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError, match="no counterpart|mix backbones"):
        params_from_flax(tree)
