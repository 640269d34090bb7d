"""The precision flags of the port against the JAX package, on the CPU:
`--bf16` / `--matmul_precision` (`amid_tpu_torch.ops.precision`, the bf16
modes of the attention core and the scoring head, the whole model in bf16)
and `--remat` (SASRec's blocks recomputed in the backward).

On this CPU the JAX package computes fp32 under `jax.default_matmul_precision
("bfloat16")`: the context changes nothing here. So the port's bf16 products
are held to JAX computations that cast explicitly (`astype(bfloat16)`
operands, `preferred_element_type=float32`; the Pallas kernel's
`mxu_bf16=True` in interpret mode) at fp32 tolerances, and the whole bf16
model to the JAX model under `use_bf16=True` (fp32 here) at a bf16-class
tolerance stated below. The gradients of the explicit-cast oracles are
written out as products of cast operands: `jax.vjp` through `astype` leaves
the cotangent unrounded and rounds the gradient itself to bf16, which is
what the casts' transposes compute, not the precision context's transposed
dots, which round their operands, the cotangent included."""

import dataclasses
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax
from jax.experimental.pallas import tpu as pltpu

from amid_tpu import config as jax_config
from amid_tpu.config import ModelConfig as JaxModelConfig
from amid_tpu.models import encoders as jax_encoders
from amid_tpu.models.amid import build_model as jax_build_model
from amid_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from amid_tpu.train import steps as jax_steps
from amid_tpu_torch import config as port_config
from amid_tpu_torch.config import ModelConfig
from amid_tpu_torch.convert import adam_state_from_optax, params_from_flax
from amid_tpu_torch.models.amid import build_model
from amid_tpu_torch.ops import attention as attn
from amid_tpu_torch.ops import precision, scoring
from amid_tpu_torch.ops.rng import StepRandom
from amid_tpu_torch.train import steps
from amid_tpu_torch.train.optim import Adam

ATOL, RTOL = 1e-5, 1e-4  # fp32 comparisons, sums in another order
HELPER_TOL = 1e-6  # the products against their explicit-cast oracles
# The port's bf16 model against the JAX model, which computes fp32 here:
# every product's operands are rounded (2^-9 relative each), so outputs and
# gradients part by bf16 rounding. Measured at the test's shapes (seed 0):
# outputs within 3.5e-3 of their largest value; the gradient of all leaves
# together within 1.6e-2 (Frobenius, relative); single leaves up to 0.18,
# the DR heads' first layer, where a hidden unit near 0 is on in one model
# and off in the other (8 hidden units, 8 users: one flip weighs). Held at
# about three times that: outputs BF16_OUT_TOL of max|jax|, all gradients
# BF16_GRAD_TOL, each leaf BF16_LEAF_TOL (leaves whose gradient is zero
# analytically, the key biases, are rounding noise in both and held only in
# the sum).
BF16_OUT_TOL, BF16_GRAD_TOL, BF16_LEAF_TOL = 1e-2, 5e-2, 0.5
BF16 = jnp.bfloat16


def _cast(x):
    return jnp.asarray(x).astype(BF16)


def _bdot(spec, a, b):
    """The explicit-cast product: bf16 operands, fp32 sums and result."""
    return jnp.einsum(spec, _cast(a), _cast(b), preferred_element_type=jnp.float32)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# the mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", ["False", "True"])
@pytest.mark.parametrize("matmul_precision", [None, "", "bfloat16", "highest", "float32"])
def test_the_mode_is_the_jax_expression_for_every_cli_pair(bf16, matmul_precision):
    """Both CLIs parse the pair into the same fields; the port's mode is JAX's
    `cfg.matmul_precision or ("bfloat16" if cfg.use_bf16 else "")`, named."""
    argv = ["--bf16", bf16] + ([] if matmul_precision is None
                               else ["--matmul_precision", matmul_precision])
    got = port_config.parse_cli(argv, is_dr=True).model
    want = jax_config.parse_cli(argv, is_dr=True).model
    assert (got.use_bf16, got.matmul_precision) == (want.use_bf16, want.matmul_precision)
    jax_name = want.matmul_precision or ("bfloat16" if want.use_bf16 else "")
    assert precision.resolve_precision(got) == ("bf16" if jax_name == "bfloat16" else "fp32")


def test_an_unknown_precision_is_refused_by_name():
    cfg = ModelConfig(matmul_precision="tensorfloat32", emb_dim=8, hid_dim=4, batch_size=2,
                      seq_len=4, item_length=10)
    with pytest.raises(ValueError, match="'tensorfloat32'"):
        precision.resolve_precision(cfg)
    with pytest.raises(ValueError, match="'tensorfloat32'"):
        build_model(cfg, device="cpu")


# ---------------------------------------------------------------------------
# the three products
# ---------------------------------------------------------------------------

def _products(rng):
    """(name, port fn of its operands, JAX spec, operand shapes)."""
    x = (3, 5, 7)
    return [
        ("linear", lambda a, w: precision.linear(a, w, None, "bf16"), "btk,nk->btn",
         [x, (4, 7)]),
        ("matmul_weight", lambda a, b: precision.matmul(a, b, "bf16"), "btk,kn->btn",
         [x, (7, 4)]),
        ("matmul_batched", lambda a, b: precision.matmul(a, b, "bf16"), "bhqd,bhdk->bhqk",
         [(2, 3, 5, 6), (2, 3, 6, 5)]),
        ("einsum_quirk", lambda a, b: precision.einsum("c,cme->me", a, b, mode="bf16"),
         "c,cme->me", [(6,), (6, 4, 5)]),
        ("einsum_pairwise", lambda a, b: precision.einsum("bc,cme->bme", a, b, mode="bf16"),
         "bc,cme->bme", [(3, 6), (6, 4, 5)]),
    ]


@pytest.mark.parametrize("which", range(5))
def test_bf16_products_and_their_gradients_match_explicit_casts(rng, which):
    """Forward against jnp.einsum of bf16 operands with fp32 sums; each
    operand's gradient against the product of the bf16 cotangent and the
    other bf16 operand (the transposed dot at the forward's precision)."""
    name, fn, spec, shapes = _products(rng)[which]
    ops = [rng.normal(size=s).astype(np.float32) for s in shapes]
    lhs, out_spec = spec.split("->")
    a_spec, b_spec = lhs.split(",")
    want = np.asarray(_bdot(spec, *ops))
    ta, tb = (torch.tensor(o, requires_grad=True) for o in ops)
    got = fn(ta, tb)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=HELPER_TOL, rtol=HELPER_TOL,
                               err_msg=name)
    g = rng.normal(size=want.shape).astype(np.float32)
    da, db = torch.autograd.grad(got, (ta, tb), torch.as_tensor(g))
    want_da = _bdot(f"{out_spec},{b_spec}->{a_spec}", g, ops[1])
    want_db = _bdot(f"{a_spec},{out_spec}->{b_spec}", ops[0], g)
    for got_g, want_g, what in ((da, want_da, "da"), (db, want_db, "db")):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=HELPER_TOL,
                                   rtol=HELPER_TOL, err_msg=f"{name} {what}")


def test_fp32_products_are_the_plain_calls(rng):
    """In fp32 the three products are exactly F.linear, torch.matmul and
    torch.einsum: an fp32 model computes what it computed before the mode."""
    x, w, b = (torch.tensor(rng.normal(size=s).astype(np.float32))
               for s in ((3, 5, 7), (4, 7), (4,)))
    assert torch.equal(precision.linear(x, w, b, "fp32"), torch.nn.functional.linear(x, w, b))
    assert torch.equal(precision.matmul(x, w.T, "fp32"), torch.matmul(x, w.T))
    assert torch.equal(precision.einsum("btk,nk->btn", x, w, mode="fp32"),
                       torch.einsum("btk,nk->btn", x, w))
    assert not torch.equal(precision.matmul(x, w.T, "bf16"), torch.matmul(x, w.T))


# ---------------------------------------------------------------------------
# K1's bf16 mode: the four plain versions against the Pallas kernel
# ---------------------------------------------------------------------------

AB, AT, AD, AH = 2, 37, 16, 2  # T=37 with key tiles of 8: the last tile partial


def _attention_inputs(rng, kind):
    q, k, v, dout = (rng.normal(size=(AB, AT, AD)).astype(np.float32) for _ in range(4))
    if kind == "causal":
        bias = np.triu(np.full((AT, AT), -1e9, np.float32), 1)[None, None]
    else:  # key padding with row 0 fully masked
        keep = rng.random((AB, AT)) < 0.7
        keep[0] = False
        bias = np.where(keep, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    return q, k, v, bias, dout


@pytest.mark.parametrize("kind", ["causal", "keypad"])
def test_attention_plain_versions_match_the_pallas_bf16_mode(rng, kind):
    """attention_plain, attention_fwd_stats_plain and the streamed version
    (tiles of 8) in bf16 mode against `fused_attention(..., mxu_bf16=True)`
    in interpret mode at rate 0, at the JAX test's own 1e-5; the backward
    (`attention_bwd_plain` from the forward's residuals, and attention_plain's
    gradient, which is the same arithmetic) against `jax.vjp` of that call.
    The backward's D_i is rowsum(dO o O), where the JAX kernel sums dP o P:
    with bf16 operands the two part by bf16 rounding, so the gradients are
    held at BWD_BF16_TOL of their largest value, and the port's arithmetic
    is held to an fp64 oracle of its own rounding points at fp32 tolerance."""
    q, k, v, bias, dout = _attention_inputs(rng, kind)
    seed = jnp.zeros((1,), jnp.int32)
    jq, jk, jv, jbias = map(jnp.asarray, (q, k, v, bias))

    def f(q_, k_, v_):
        return jax_fused_attention(q_, k_, v_, jbias, seed, AH, 0.0, True)

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(f, jq, jk, jv)
        want_grads = vjp(jnp.asarray(dout))
    want = np.asarray(want)
    tq, tk, tv, tbias = map(torch.as_tensor, (q, k, v, bias))
    outs = {
        "attention_plain": attn.attention_plain(tq, tk, tv, tbias, 0, AH, 0.0, True),
        "fwd_stats": attn.attention_fwd_stats_plain(tq, tk, tv, tbias, 0, AH, 0.0, True)[0],
        "streamed": attn.attention_fwd_stats_streamed_plain(tq, tk, tv, tbias, 0, AH, 0.0,
                                                            block_k=8, mxu_bf16=True)[0],
    }
    for name, got in outs.items():
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5, err_msg=name)
    exact = attn.attention_plain(tq, tk, tv, tbias, 0, AH, 0.0).numpy()
    assert np.abs(exact - want).max() > 1e-4  # the mode is on

    out, m, inv = attn.attention_fwd_stats_plain(tq, tk, tv, tbias, 0, AH, 0.0, True)
    _, m_s, inv_s = attn.attention_fwd_stats_streamed_plain(tq, tk, tv, tbias, 0, AH, 0.0,
                                                            block_k=8, mxu_bf16=True)
    np.testing.assert_allclose(m_s.numpy(), m.numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(inv_s.numpy(), inv.numpy(), atol=1e-7, rtol=1e-6)
    grads = attn.attention_bwd_plain(tq, tk, tv, tbias, out, m, inv, torch.as_tensor(dout),
                                     0, AH, 0.0, True)
    auto = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    auto_grads = torch.autograd.grad(attn.attention_plain(*auto, tbias, 0, AH, 0.0, True),
                                     auto, torch.as_tensor(dout))
    oracle = _attention_bwd_oracle(q, k, v, bias, out.numpy(), dout)
    for name, got, auto_g, jw, ow in zip("qkv", grads, auto_grads, want_grads, oracle):
        jw = np.asarray(jw)
        assert torch.equal(got, auto_g), name
        np.testing.assert_allclose(got.numpy(), ow, atol=ATOL, rtol=RTOL, err_msg=name)
        assert np.abs(got.numpy() - jw).max() <= BWD_BF16_TOL * np.abs(jw).max(), name


# |port - jax| over max|jax| of dq, dk, dv (D_i's rounding): measured 6.2e-3
# (dq, causal), 3.9e-3 (dk), 0 (dv: the same rounded product in both)
BWD_BF16_TOL = 2e-2


def _bf(x):
    """numpy float32 rounded to bf16 (nearest even), in float64."""
    return np.asarray(jnp.asarray(x, jnp.float32).astype(BF16).astype(jnp.float32),
                      np.float64)


def _attention_bwd_oracle(q, k, v, bias, out, dout):
    """dq, dk, dv in fp64 with the port's rounding points: the scores and
    the four gradient products on bf16 operands, D_i = rowsum(dO o O)."""
    dh = AD // AH

    def heads(x):
        return x.reshape(AB, AT, AH, dh).transpose(0, 2, 1, 3)

    def merge(x):
        return x.transpose(0, 2, 1, 3).reshape(AB, AT, AD)

    qh, kh, vh, gh, oh = (heads(x) for x in (q, k, v, dout, out))
    # the bias is added in fp32, as both packages add it: a masked score is
    # -1e9 plus a rounding of it, so a fully masked row is uniform
    s = ((_bf(qh) @ _bf(kh).transpose(0, 1, 3, 2) / math.sqrt(dh)).astype(np.float32)
         + bias).astype(np.float64)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    d_row = (gh.astype(np.float64) * oh).sum(-1, keepdims=True)
    dp = _bf(gh) @ _bf(vh).transpose(0, 1, 3, 2)
    dv = _bf(p).transpose(0, 1, 3, 2) @ _bf(gh)
    ds = p * (dp - d_row)
    dq = _bf(ds) @ _bf(kh) / math.sqrt(dh)
    dk = _bf(ds).transpose(0, 1, 3, 2) @ _bf(qh) / math.sqrt(dh)
    return merge(dq), merge(dk), merge(dv)


# ---------------------------------------------------------------------------
# K5's bf16 mode
# ---------------------------------------------------------------------------

def test_scoring_head_bf16_matches_its_jax_oracle(rng):
    """The plain pair in bf16 against the JAX head's XLA arithmetic with
    both products' operands cast (user, W_u; items, W_i; the hidden unit and
    w2), at fp32 tolerance; the kernel route's backward (its recomputation in
    bf16, on CPU tensors) against autograd through the plain pair."""
    b, c, d, h = 4, 6, 8, 5
    u1, u2 = (rng.normal(size=(b, d)).astype(np.float32) for _ in range(2))
    items = rng.normal(size=(b, c, d)).astype(np.float32)
    w1 = (rng.normal(size=(h, 2 * d)) * 0.3).astype(np.float32)
    b1, w2, b2 = (rng.normal(size=s).astype(np.float32) for s in ((h,), (1, h), (1,)))
    ku, ki = w1[:, :d].T, w1[:, d:].T  # the JAX head's [D, H] halves
    i_part = _bdot("bcd,dh->bch", items, ki)

    def score(u):
        hidden = jax.nn.relu(_bdot("bd,dh->bh", u, ku)[:, None, :] + i_part + b1)
        return jax.nn.sigmoid(_bdot("bch,ho->bco", hidden, w2.T)[..., 0] + b2[0])

    params = [torch.tensor(x, requires_grad=True) for x in (u1, u2, items, w1, b1, w2, b2)]

    def run(fn, ps):
        tu1, tu2, titems, tw1, tb1, tw2, tb2 = ps
        return fn(tu1, tu2, titems, tw1[:, :d], tw1[:, d:], tb1, tw2, tb2, bf16=True)

    plain = run(scoring.scoring_head_pair_plain, params)
    for got, u in zip(plain, (u1, u2)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(score(u)),
                                   atol=HELPER_TOL, rtol=HELPER_TOL)
    weights = [torch.as_tensor(rng.normal(size=(b, c)).astype(np.float32)) for _ in range(2)]
    want = torch.autograd.grad(sum((o * w).sum() for o, w in zip(plain, weights)), params)
    params2 = [p.detach().clone().requires_grad_() for p in params]
    routed = run(scoring.scoring_head_pair, params2)
    got = torch.autograd.grad(sum((o * w).sum() for o, w in zip(routed, weights)), params2)
    for name, g, w in zip(("u1", "u2", "items", "w1", "b1", "w2", "b2"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=HELPER_TOL, rtol=1e-5,
                                   err_msg=name)
    fp32 = scoring.scoring_head_pair_plain(*params[:3], params[3][:, :d], params[3][:, d:],
                                           *params[4:])
    assert (fp32[0] - plain[0]).abs().max() > 1e-6  # the mode is on


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

MB, MT, MD, VOCAB = 8, 6, 16, 50
MODEL_KW = dict(emb_dim=MD, hid_dim=8, batch_size=MB, seq_len=MT, is_itc=True, ts2=0.12,
                is_dr=True, item_length=VOCAB, user_length=VOCAB, sasrec_heads=2,
                sasrec_dropout=0.0, bert_heads=2, bert_ff_dim=32, bert_dropout=0.0)
OUT_KEYS = ("u_d1", "u_d2", "logits_d1", "logits_d2", "ips_d1", "ips_d2", "gfunc_d1",
            "gfunc_d2")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(rng, t=MT):
    hi = 2 * VOCAB
    return {"seq_d1": rng.integers(1, hi, (MB, t)).astype(np.int32),
            "seq_d2": rng.integers(0, hi, (MB, t)).astype(np.int32),
            "target": rng.integers(0, hi, MB).astype(np.int32),
            "neg_samples": rng.integers(0, hi, (MB, 3)).astype(np.int32)}


def _jax_and_port(rng, **kw):
    jcfg = JaxModelConfig(**{**MODEL_KW, **kw}, kernels="xla")
    jmodel = jax_build_model(jcfg)
    batch = _batch(rng)
    key = jax.random.PRNGKey(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jmodel.init({"params": key, "dropout": key}, jb, train=False)["params"]
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ModelConfig)
                         if f.name != "kernels"})
    port = build_model(cfg, device="cpu")
    port.load_state_dict(params_from_flax(_np_tree(params)), strict=True)
    return jmodel, params, port, batch


def _weights(rng):
    return {k: rng.normal(size=(MB, 4 if k.startswith(("logits", "ips", "gfunc")) else MD))
            .astype(np.float32) for k in OUT_KEYS}


def _jax_outputs_and_grads(jmodel, params, batch, weights, train=False):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        out = jmodel.apply({"params": p}, jb, train=train,
                           rngs={"dropout": jax.random.PRNGKey(1)} if train else None)
        return sum(jnp.sum(out[k] * weights[k]) for k in OUT_KEYS), out

    with pltpu.force_tpu_interpret_mode():
        (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return out, params_from_flax(_np_tree(grads))


def _port_outputs_and_grads(port, batch, weights, rng_=None):
    out = port(batch, rng=rng_)
    loss = sum((out[k] * torch.as_tensor(weights[k])).sum() for k in OUT_KEYS)
    names, leaves = zip(*port.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, out, {n: torch.zeros_like(p) if g is None else g
                       for n, p, g in zip(names, leaves, grads)}


@pytest.mark.parametrize("backbone", ["sasrec", "bert4rec", "gru4rec"])
def test_bf16_model_matches_the_jax_model_under_use_bf16(rng, monkeypatch, backbone):
    """Each backbone with InterComp (quirk gates) and the DR heads: outputs
    and the gradient of every leaf within the BF16_* tolerances of the JAX model built
    with `use_bf16=True`; the port's bf16 model parts from its fp32 model
    (the mode is on), and `matmul_precision="highest"` is the default fp32
    model bit for bit. BERT4Rec's JAX side runs its Pallas attention (the
    port's additive key mask, `test_torch_backbones.py`), the others XLA's."""
    kw = dict(backbone=backbone, use_bf16=True)
    jmodel, params, port, batch = _jax_and_port(rng, **kw)
    if backbone == "bert4rec":
        monkeypatch.setattr(jax_encoders, "PALLAS_ATTN_MIN_T", 1)
        jmodel = jax_build_model(JaxModelConfig(**{**MODEL_KW, **kw}, kernels="pallas"))
    assert port.precision == "bf16"
    weights = _weights(rng)
    want, want_grads = _jax_outputs_and_grads(jmodel, params, batch, weights)
    _, out, grads = _port_outputs_and_grads(port, batch, weights)
    for k in OUT_KEYS:
        ref = np.asarray(want[k])
        assert np.abs(out[k].detach().numpy() - ref).max() <= BF16_OUT_TOL * np.abs(ref).max(), k
    assert grads.keys() == want_grads.keys()
    diff = ref_norm = 0.0
    for name, g in grads.items():
        ref = want_grads[name].numpy()
        d = np.linalg.norm(g.numpy() - ref)
        diff, ref_norm = diff + d ** 2, ref_norm + np.linalg.norm(ref) ** 2
        if np.abs(ref).max() > 1e-6:
            assert d <= BF16_LEAF_TOL * np.linalg.norm(ref), name
    assert math.sqrt(diff) <= BF16_GRAD_TOL * math.sqrt(ref_norm)
    cfg = dataclasses.replace(port.cfg, use_bf16=False)
    fp32, highest = (build_model(dataclasses.replace(cfg, matmul_precision=mp), device="cpu")
                     for mp in ("", "highest"))
    for m in (fp32, highest):
        m.load_state_dict(port.state_dict())
    with torch.no_grad():
        a, h, b16 = fp32(batch), highest(batch), port(batch)
    assert all(torch.equal(a[k], h[k]) for k in OUT_KEYS)
    assert (a["logits_d1"] - b16["logits_d1"]).abs().max() > 1e-6


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def test_remat_equals_no_remat_under_dropout_from_one_key(rng):
    """SASRec at dropout 0.5 in train mode, one StepRandom key: the remat
    model's loss and every gradient equal the model's without remat bit for
    bit, and the step's generator ends in the same state (the recompute
    replays the forward's draws and draws nothing)."""
    kw = dict(backbone="sasrec", sasrec_dropout=0.5)
    _, params, plain, batch = _jax_and_port(rng, **kw)
    remat = build_model(dataclasses.replace(plain.cfg, remat=True), device="cpu")
    remat.load_state_dict(plain.state_dict())
    weights = _weights(rng)
    results = []
    for model in (plain, remat):
        model.train()
        step_rng = StepRandom(1234, "cpu")
        loss, _, grads = _port_outputs_and_grads(model, batch, weights, step_rng)
        results.append((loss, grads, step_rng.dropout_gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = results
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    assert torch.equal(s0, s1)
    assert remat.enc_d1.remat and not plain.enc_d1.remat


def test_remat_model_matches_the_jax_remat_model(rng):
    """The remat model in train mode against the JAX model built with
    `remat=True` (nn.remat), dropout off: outputs and every gradient at the
    port's fp32 tolerances."""
    jmodel, params, port, batch = _jax_and_port(rng, backbone="sasrec", remat=True)
    assert port.enc_d1.remat
    weights = _weights(rng)
    want, want_grads = _jax_outputs_and_grads(jmodel, params, batch, weights, train=True)
    port.train()
    _, out, grads = _port_outputs_and_grads(port, batch, weights)
    for k in OUT_KEYS:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(want[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# a dense phase-A step, as tests/test_torch_train.py holds it
# ---------------------------------------------------------------------------

LR, LR2, DR_E_W = 1e-3, 2e-3, 0.1
# measured (seed 0): losses 4.3e-5 apart, parameters 2.3e-4 (a quarter of
# LR), mu 7.5e-3 and nu 1.3e-2 of their largest value; held at about 4x
STEP_BF16_TOL = {"metric": 2e-4, "params": LR, "mu": 3e-2, "nu": 5e-2}


def _step_batch(rng):
    v = 2 * VOCAB
    return {"target": rng.integers(0, v, MB).astype(np.int32),
            "seq_d1": rng.integers(0, v, (MB, MT)).astype(np.int32),
            "seq_d2": rng.integers(0, v, (MB, MT)).astype(np.int32),
            "domain_id": rng.integers(0, 2, MB).astype(np.int32),
            "reject": np.concatenate([np.sort(rng.integers(0, v, (MB, 2)), axis=1),
                                      np.full((MB, 1), v)], axis=1).astype(np.int32),
            "reject_counts": np.full(MB, 2, np.int32),
            "ob_label": rng.integers(0, 2, MB).astype(np.int32)}


@pytest.mark.parametrize("flag", ["use_bf16", "remat"])
def test_dense_phase_a_step_matches_jax(rng, flag):
    """One JAX phase-A and phase-B step make non-zero moments; the state is
    converted and one more phase-A step runs in both packages with the same
    batch and negatives. Under remat (dropout off) metrics, parameters and
    moments agree at fp32 tolerances; under bf16 (the JAX step fp32 here) at
    STEP_BF16_TOL (moments relative to the array's largest value): Adam's
    update is lr times a normalised gradient, so a gradient's bf16 error
    moves a parameter by a share of lr."""
    from amid_tpu.data.sampler import sample_negatives as jax_sample_negatives

    jmodel, params, _, _ = _jax_and_port(rng, backbone="sasrec", **{flag: True})
    pools = np.tile(np.arange(2 * VOCAB, dtype=np.int32)[None], (2, 1))
    sizes = np.array([2 * VOCAB, 2 * VOCAB], np.int32)
    jp, jps = jnp.asarray(pools), jnp.asarray(sizes)
    tx, tx2 = optax.adam(LR), optax.adam(LR2)
    jstate = jax_steps.TrainState(params, tx.init(params), tx2.init(params))
    jstep_a = jax_steps.make_train_step(jmodel, tx, dr_e_w=DR_E_W)
    jstep_b = jax_steps.make_dr_r_step(jmodel, tx2)
    for i, jstep in enumerate((jstep_a, jstep_b)):
        batch = {k: jnp.asarray(v) for k, v in _step_batch(rng).items()}
        jstate, _ = jstep(jstate, batch, jp, jps, jax.random.PRNGKey(100 + i))

    cfg = ModelConfig(**{**MODEL_KW, "backbone": "sasrec", flag: True})
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_flax(_np_tree(jstate.params)), strict=True)

    def moments(s):
        return np.asarray(s[0].count), _np_tree(s[0].mu), _np_tree(s[0].nu)

    state = steps.TrainState(dict(model.named_parameters()),
                             adam_state_from_optax(*moments(jstate.opt_state)),
                             adam_state_from_optax(*moments(jstate.opt_state2)))
    step_a = steps.make_train_step(model, Adam(LR), dr_e_w=DR_E_W)
    batch, key = _step_batch(rng), jax.random.PRNGKey(7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    k_neg = jax.random.split(key, 4)[0]
    neg = np.array(jax_sample_negatives(k_neg, jp, jps, jb["domain_id"], jb["reject"], 1,
                                        jb["reject_counts"]))
    jstate, jm = jstep_a(jstate, jb, jp, jps, key)
    state, m = step_a(state, {k: torch.as_tensor(v) for k, v in batch.items()},
                      torch.as_tensor(pools), torch.as_tensor(sizes), 0, neg=neg)
    assert m.keys() == jm.keys()
    bf = flag == "use_bf16"
    for k in jm:
        if bf:
            assert abs(float(m[k]) - float(jm[k])) <= STEP_BF16_TOL["metric"], k
        else:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=ATOL, rtol=RTOL,
                                       err_msg=k)
    _, mu, nu = moments(jstate.opt_state)
    for what, got, want in (("params", state.params, jstate.params),
                            ("mu", state.opt_state.mu, mu), ("nu", state.opt_state.nu, nu)):
        want = params_from_flax(_np_tree(want))
        for name, w in want.items():
            g, w = got[name].detach().numpy(), w.numpy()
            if name.endswith("in_proj_bias"):  # the K third: rounding noise (test_torch_train)
                g, w = np.delete(g, slice(MD, 2 * MD)), np.delete(w, slice(MD, 2 * MD))
            if bf:
                tol = STEP_BF16_TOL[what] * (np.abs(w).max() if what != "params" else 1.0)
                assert np.abs(g - w).max() <= tol, f"{what} {name}"
            else:
                np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=f"{what} {name}")
