"""The kernels at the widths the JAX kernels take, on the CPU.

The long attention pair takes head widths up to 256 in fp32 and in bf16
(template width 256 for dh 129 to 256), the affinity kernels (K6/K7) any D
and any N, the scoring head (K5) any D and H. On the card each kernel is
held to its plain version; here the plain versions are held to the JAX
package's Pallas kernels in interpret mode: the long forward in key tiles
(`attention_fwd_stats_streamed_plain`) and the backward at dh=160 and 256,
in fp32 and with `mxu_bf16`, `max_affinity_plain` at D 20, 136 and 256 and
at N=700, the scoring head at D 90, 258 and 1,030. Then the plans at
D=1,024 and N=700 and K5's at any (D, H) counted out, the fold of a query
that spans several blocks, a configuration-(c)-shaped model (BERT4Rec at
dh=256, pairwise, InterComp) and a configuration-(d)-shaped one (the same
under `use_bf16`) against the JAX model, and what `check_kernels_fit`
takes and refuses. fp32 on both sides, dropout off, atol 1e-5 / rtol 1e-4,
unless a test says otherwise."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax
from jax.experimental.pallas import tpu as pltpu

from amid_tpu.config import ModelConfig as JaxModelConfig
from amid_tpu.data.sampler import sample_negatives as jax_sample_negatives
from amid_tpu.models.amid import build_model as jax_build_model
from amid_tpu.ops.pallas_affinity import max_affinity_pallas, max_affinity_pallas_smalln
from amid_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from amid_tpu.ops.pallas_scoring import scoring_head_pallas
from amid_tpu.serve import user_representations as jax_user_representations
from amid_tpu.train import steps as jax_steps
from amid_tpu_torch.config import ModelConfig
from amid_tpu_torch.convert import adam_state_from_optax, params_from_flax
from amid_tpu_torch.models.amid import AMIDModel, check_kernels_fit, head_width
from amid_tpu_torch.ops import affinity, scoring
from amid_tpu_torch.ops import attention as attention_ops
from amid_tpu_torch.ops.affinity import max_affinity_xla
from amid_tpu_torch.ops.attention import (
    attention_bwd_plain, attention_fwd_stats_plain, attention_fwd_stats_streamed_plain,
)
from amid_tpu_torch.serve import user_representations
from amid_tpu_torch.train import steps
from amid_tpu_torch.train.optim import Adam
from test_torch_c2dsr import kernel_limits  # noqa: F401 (a fixture)
from test_torch_precision import (
    BF16_GRAD_TOL, BF16_LEAF_TOL, BF16_OUT_TOL, BWD_BF16_TOL, OUT_KEYS,
    _jax_outputs_and_grads, _port_outputs_and_grads, _weights,
)

ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# K1: the fp32 long pair above head width 128
# ---------------------------------------------------------------------------

def _attention_inputs(rng, b, t, d, kind):
    q, k, v, dout = (rng.normal(size=(b, t, d)).astype(np.float32) for _ in range(4))
    if kind == "causal":
        bias = np.triu(np.full((t, t), -1e9, np.float32), 1)[None, None]
    else:  # key padding with batch row 0 fully masked
        keep = rng.random((b, t)) < 0.7
        keep[0] = False
        bias = np.where(keep, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    return q, k, v, bias, dout


@pytest.mark.parametrize("kind", ["causal", "keypad"])
@pytest.mark.parametrize("dh,heads", [(160, 1), (256, 2)])
def test_long_plain_versions_match_the_pallas_kernel_above_128(rng, dh, heads, kind):
    """The long forward's plain version in key tiles of 8 (the kernel's
    stage at template width 256; the last partial) and 64, its row
    statistics, and the backward from those residuals, against the Pallas
    kernel in interpret mode and its `jax.vjp`; both routes take the long
    paths at this width, in fp32 only."""
    b, t = 2, 13
    q, k, v, bias, dout = _attention_inputs(rng, b, t, dh * heads, kind)
    seed = jnp.zeros((1,), jnp.int32)

    def f(q_, k_, v_):
        return jax_fused_attention(q_, k_, v_, jnp.asarray(bias), seed, heads, 0.0)

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
        want_grads = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    tq, tk, tv, tbias, tdout = map(torch.as_tensor, (q, k, v, bias, dout))
    whole = attention_fwd_stats_plain(tq, tk, tv, tbias, 0, heads, 0.0)
    for block_k in (8, 64):
        res = attention_fwd_stats_streamed_plain(tq, tk, tv, tbias, 0, heads, 0.0, block_k)
        np.testing.assert_allclose(res[0].numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(res[1], whole[1], atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(res[2], whole[2], atol=1e-7, rtol=1e-6)
        grads = attention_bwd_plain(tq, tk, tv, tbias, *res, tdout, 0, heads, 0.0)
        for name, g, w in zip("qkv", grads, want_grads):
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL,
                                       err_msg=f"block_k={block_k} d{name}")
    assert attention_ops.long_head_dim(dh) == 256 and attention_ops.kernel_head_dim(dh) is None
    for mode in attention_ops.MODES:
        for t_route in (1, 20, 300):
            assert attention_ops.forward_route(t_route, dh, mode) == "long"
            assert attention_ops.backward_route(t_route, dh, mode) == "long"
    attention_ops.check_head_width(dh)  # both modes take it
    assert attention_ops.bf16_packed_shape(13, dh) == (128, 256)


@pytest.mark.parametrize("kind", ["causal", "keypad"])
@pytest.mark.parametrize("dh,heads", [(160, 1), (256, 2)])
def test_bf16_plain_versions_match_the_pallas_bf16_mode_above_128(rng, dh, heads, kind):
    """The bf16 mode's plain versions at template width 256, as
    `test_torch_precision.py` holds them at dh=8: attention_plain,
    attention_fwd_stats_plain and the streamed version (tiles of 8 and of 64,
    the bf16 long forward's stage) against `fused_attention(...,
    mxu_bf16=True)` in interpret mode at 1e-5; the row statistics of the
    streamed version against the whole-row ones; attention_bwd_plain from
    those residuals, equal to attention_plain's autograd gradient, within
    BWD_BF16_TOL of the largest of `jax.vjp`'s (D_i's rounding; see there)."""
    b, t = 2, 13
    q, k, v, bias, dout = _attention_inputs(rng, b, t, dh * heads, kind)
    seed = jnp.zeros((1,), jnp.int32)

    def f(q_, k_, v_):
        return jax_fused_attention(q_, k_, v_, jnp.asarray(bias), seed, heads, 0.0, True)

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
        want_grads = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    want = np.asarray(want)
    tq, tk, tv, tbias, tdout = map(torch.as_tensor, (q, k, v, bias, dout))
    out, m, inv = attention_fwd_stats_plain(tq, tk, tv, tbias, 0, heads, 0.0, True)
    outs = {"attention_plain": attention_ops.attention_plain(tq, tk, tv, tbias, 0, heads, 0.0,
                                                             True), "fwd_stats": out}
    for block_k in (8, 64):
        res = attention_fwd_stats_streamed_plain(tq, tk, tv, tbias, 0, heads, 0.0, block_k, True)
        outs[f"streamed_{block_k}"] = res[0]
        torch.testing.assert_close(res[1], m, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(res[2], inv, atol=1e-7, rtol=1e-6)
    for name, got in outs.items():
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5, err_msg=name)
    exact = attention_ops.attention_plain(tq, tk, tv, tbias, 0, heads, 0.0).numpy()
    assert np.abs(exact - want).max() > 1e-4  # the mode is on
    grads = attention_bwd_plain(tq, tk, tv, tbias, out, m, inv, tdout, 0, heads, 0.0, True)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    auto = torch.autograd.grad(attention_ops.attention_plain(*leaves, tbias, 0, heads, 0.0, True),
                               leaves, tdout)
    for name, got, auto_g, w in zip("qkv", grads, auto, want_grads):
        assert torch.equal(got, auto_g), name
        assert np.abs(got.numpy() - w).max() <= BWD_BF16_TOL * np.abs(w).max(), name


@pytest.mark.parametrize("name,bf16,dh,lib", [
    ("attention_fwd", False, 12, "attention_fwd"),
    ("attention_fwd", True, 128, "attention_fwd_bf16"),
    ("attention_bwd", False, 48, "attention_bwd"),
    ("attention_bwd", True, 24, "attention_bwd_bf16"),
    ("attention_fwd_long", False, 128, "attention_fwd_long"),
    ("attention_fwd_long", False, 256, "attention_fwd_long"),
    ("attention_fwd_long", False, 12, "attention_fwd_long_pad"),
    ("attention_fwd_long", False, 160, "attention_fwd_long_pad"),
    ("attention_bwd_long", False, 96, "attention_bwd_long_pad"),
    ("attention_bwd_long", True, 128, "attention_bwd_long_bf16"),
    ("attention_bwd_long", True, 12, "attention_bwd_long_bf16"),
    ("attention_fwd_long", True, 129, "attention_fwd_long_bf16_dh256"),
    ("attention_bwd_long", True, 256, "attention_bwd_long_bf16_dh256"),
])
def test_each_launch_takes_the_build_of_its_mode_and_width(monkeypatch, name, bf16, dh, lib):
    """The one entry table: the fp32 long paths take their `_pad` build at a
    padded width (not 16, 32, 64, 128 or 256), the bf16 long paths their
    `_bf16_dh256` build above head width 128, every other launch its
    source's (the bf16 mode's `_bf16` source) at every width."""
    monkeypatch.setattr(attention_ops, "_entry", {n: n for n in attention_ops._LIBRARIES})
    assert attention_ops._entry_point(name, bf16, dh) == lib


# ---------------------------------------------------------------------------
# K6/K7: any D and any N
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jax_kernel", ["blocked", "smalln"])
@pytest.mark.parametrize("d", [20, 136, 256])
def test_max_affinity_plain_matches_the_pallas_kernels_at_any_width(rng, jax_kernel, d):
    """D not a multiple of 8, just above one 128-column plane and two planes:
    the same bf16 inputs, exact products, fp32 sums in another order."""
    a, b = (rng.normal(size=s).astype(np.float32) for s in ((2, 7, d), (2, 5, d)))
    fn = max_affinity_pallas if jax_kernel == "blocked" else max_affinity_pallas_smalln
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(jnp.asarray(a), jnp.asarray(b)))
    got = affinity.max_affinity_plain(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the wrappers take the plain version on CPU tensors at every width
    for kernel in (affinity.max_affinity_blocked, affinity.max_affinity_smalln):
        assert torch.equal(kernel(torch.as_tensor(a), torch.as_tensor(b)), got)


def test_max_affinity_plain_matches_the_pallas_kernel_beyond_640_rows(rng):
    """N=700 (eight slots of 88 rows a user at D <= 128, twelve of 64 above:
    two and three blocks a user on the card) against the blocked Pallas
    kernel."""
    a, b = (rng.normal(size=s).astype(np.float32) for s in ((2, 700, 20), (2, 9, 20)))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(max_affinity_pallas(jnp.asarray(a), jnp.asarray(b)))
    got = affinity.max_affinity_plain(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel,shape", [
    ("blocked", (256, 256, 150, 150, 1024)), ("blocked", (256, 256, 20, 20, 1024)),
    ("blocked", (2, 2, 700, 700, 1024)), ("blocked", (256, 256, 700, 150, 128)),
    ("blocked", (3, 4, 700, 9, 20)), ("smalln", (256, 256, 20, 20, 1024)),
    ("smalln", (37, 300, 10, 9, 1024)), ("smalln", (11, 13, 40, 40, 136)),
])
def test_plans_at_width_1024_and_n_700_fit_and_cover_every_column(kernel, shape):
    """Each plan's shared memory is the kernels' formula within 232,448
    bytes; its planes hold every column (and no whole plane more), its slots
    every query row of every user, its slices every peer; a slot is at most
    80 rows wide above one plane and the chunks a user are 1, 2 or a
    multiple of 4."""
    b, c, n, m, d = shape
    plan = (affinity.blocked_plan if kernel == "blocked" else affinity.smalln_plan)(*shape)
    assert plan.planes * 128 >= d > (plan.planes - 1) * 128
    assert plan.smem == affinity.affinity_smem_bytes(plan.width, plan.stages, plan.peers,
                                                     plan.users, plan.planes) <= 232448
    assert plan.width <= (160 if d <= 128 else 80) and plan.width % 8 == 0
    assert plan.width * plan.chunks >= n * plan.users
    assert plan.chunks in (1, 2) or plan.chunks % 4 == 0
    assert plan.groups * affinity.SLOTS * plan.users >= b * plan.chunks
    assert plan.slices * plan.peers >= c > (plan.slices - 1) * plan.peers
    # the least dynamic shared memory a stage can take: one plane of a bank
    # tile and, above one plane, the four slots' plane beside it
    per_stage = affinity.TILE_BYTES + (affinity.SLOTS * plan.width * 256 if d > 128 else 0)
    assert plan.smem >= plan.stages * per_stage


@pytest.mark.parametrize("n,d", [(641, 128), (700, 1024), (1300, 20)])
def test_a_query_of_more_than_four_slots_folds_across_blocks(rng, n, d):
    """The blocked kernel's schedule at KC > 4, emulated block by block: a
    block holds four slots of one user (rows past its last repeat the last),
    each block folds its maximum into out[b, c] with a max that starts below
    every float (the wrapper's 0xff fill), KC / 4 blocks a user; the result
    is the exact maximum."""
    b, c, m = 3, 4, 5
    plan = affinity.blocked_plan(b, c, n, m, d)
    kc, w = plan.chunks, plan.width
    assert kc > 4 and kc % 4 == 0 and plan.groups == b * kc // 4
    scores = rng.normal(size=(b, n, c, m))
    out = np.full((b, c), -np.inf)
    blocks = np.zeros(b, int)
    for group in range(plan.groups):
        slots = range(group * 4, group * 4 + 4)
        users = {s // kc for s in slots}
        assert len(users) == 1  # four slots of one user
        user = users.pop()
        rows = [min((s % kc) * w + j, n - 1) for s in slots for j in range(w)]
        out[user] = np.maximum(out[user], scores[user, rows].max(axis=(0, 2)))
        blocks[user] += 1
    assert (blocks == kc // 4).all()
    np.testing.assert_array_equal(out, scores.max(axis=(1, 3)))


# ---------------------------------------------------------------------------
# K5: any D and H
# ---------------------------------------------------------------------------

def test_scoring_plan_takes_wide_rows_in_column_chunks():
    """Up to D=560 at H=32 a whole candidate tile fits beside Wi^T; beyond,
    the tile is staged in chunks of the widest multiple of 16 columns that
    fits (320 at configuration (c)'s D=1,024), within a block's 232,448
    bytes, up to D=1,376 at H=32 (704 at H=64); beyond that, and at a D not
    a multiple of 4, the wide kernel takes the shape in chunks of 256
    columns of the tile and of Wi^T, 103,552 bytes at every D and H."""
    assert scoring.tile_cols(512, 32) == 512 and scoring.scoring_smem_bytes(512, 32) == 205952
    assert scoring.tile_cols(1024, 32) == 320
    assert scoring.scoring_smem_bytes(1024, 32) == 4 * (1024 * 36 + 32 + 64 * 324) == 230528
    plan = scoring.scoring_plan(256, 1000, 1024, 32)
    assert plan.smem == 230528 and plan.tiles == 4000
    for d, h in ((1376, 32), (704, 64)):
        assert scoring.scoring_kernel(d, h) == "chunked"
        assert scoring.scoring_plan(4, 5, d, h).smem <= scoring.SMEM_LIMIT
        assert scoring.tile_cols(d, h) % 16 == 0
        wide = scoring.scoring_plan(4, 5, d + 8, h)
        assert scoring.scoring_kernel(d + 8, h) == "wide" and scoring.tile_cols(d + 8, h) == 256
        assert wide.smem == 4 * (64 * 260 + 256 * 36 + 32) == 103552
    assert scoring.scoring_kernel(1024, 64) == scoring.scoring_kernel(1026, 32) == "wide"
    assert scoring.scoring_kernel(30, 4) == "wide"  # D not a multiple of 4
    assert scoring.scoring_plan(256, 1000, 1024, 64) == (4000, 16, 250, 103552)  # 2 an SM


@pytest.mark.parametrize("d", [4, 30, 90, 128, 258, 560, 704, 1024, 1026, 1376, 2048, 4096])
def test_scoring_plans_fit_and_cover_every_column_and_unit_once(d):
    """At every D and H up to (4,096, 256) the main kernel's and the user
    half's shared memory is within a block's 232,448 bytes, and the main
    kernel's loops (csrc/scoring_head.cu: passes of 32 units from `h0` over
    ceil8(H), within each chunks of `tile_cols` columns from `col0` over D)
    emulated here cover every column [0, D) and every unit [0, ceil8(H))
    exactly once, and the chunks' item products summed per pass are the
    whole product; the whole-tile kernel takes one chunk, the chunked one
    stages Wi^T whole, the wide one exactly where neither fits or D is not a
    multiple of 4."""
    rng = np.random.default_rng(d)
    items = rng.normal(size=(3, d))
    for h in (1, 8, 12, 32, 33, 64, 100, 256):
        kernel = scoring.scoring_kernel(d, h)
        assert scoring.scoring_smem_bytes(d, h) <= scoring.SMEM_LIMIT
        assert scoring.user_half_smem_bytes(d, h) <= scoring.SMEM_LIMIT
        assert scoring.scoring_plan(3, 7, d, h).smem == scoring.scoring_smem_bytes(d, h)
        kw, h8 = scoring.tile_cols(d, h), -(-h // 8) * 8
        w_item = np.zeros((d, h8))
        w_item[:, :h] = rng.normal(size=(d, h))
        seen = np.zeros((d, h8), int)
        got = np.zeros((3, h8))
        chunks = 0
        for h0 in range(0, h8, 32):
            units = slice(h0, min(h0 + 32, h8))
            for col0 in range(0, d, kw):
                cols = slice(col0, min(col0 + kw, d))
                seen[cols, units] += 1
                got[:, units] += items[:, cols] @ w_item[cols, units]
                chunks += h0 == 0
        assert (seen == 1).all()
        np.testing.assert_allclose(got, items @ w_item, rtol=1e-12, atol=1e-12)
        whole_fits = d % 4 == 0 and scoring._smem_with(d, h, -(-d // 8) * 8) <= 232448
        some_fit = d % 4 == 0 and scoring._smem_with(d, h, 16) <= 232448
        assert kernel == ("whole" if whole_fits else "chunked" if some_fit else "wide")
        assert (chunks == 1) == (kernel == "whole" or d <= 256)


@pytest.mark.parametrize("d,h", [(90, 12), (258, 64), (1030, 8)])
def test_scoring_plain_versions_match_the_pallas_kernel_at_any_width(rng, d, h):
    """`scoring_head_plain` and `scoring_head_pair_plain`, forward and all
    gradients, against `scoring_head_pallas` in interpret mode and its
    `jax.grad` at D not a multiple of 4 (90, 1,030), above two 128-column
    planes (258) and H not a multiple of 8 (12), as
    `test_torch_kernel_ops.py` holds them at D=128: forward 1e-5, gradients
    rtol 1e-4 / atol 1e-5."""
    b, c = 3, 37
    user, other = (rng.normal(size=(b, d)).astype(np.float32) for _ in range(2))
    items = rng.normal(size=(b, c, d)).astype(np.float32)
    fc1 = (rng.normal(size=(h, 2 * d)) * 0.05).astype(np.float32)
    b1, w2, b2 = ((rng.normal(size=s) * 0.1).astype(np.float32) for s in ((h,), (1, h), (1,)))

    def jax_args(u):
        return tuple(map(jnp.asarray, (u, items, fc1[:, :d].T, fc1[:, d:].T, b1, w2.T, b2)))

    def jax_loss(*a):
        return jnp.sum(scoring_head_pallas(*a) ** 2)

    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(scoring_head_pallas(*jax_args(u))) for u in (user, other)]
        want_grads = jax.grad(jax_loss, argnums=tuple(range(7)))(*jax_args(user))
    leaves = [torch.tensor(x, requires_grad=True) for x in (user, other, items, fc1, b1, w2, b2)]
    u, o, it, w, tb1, tw2, tb2 = leaves
    params = (w[:, :d], w[:, d:], tb1, tw2, tb2)
    single = scoring.scoring_head_plain(u, it, *params)
    pair = scoring.scoring_head_pair_plain(u, o, it, *params)
    for got, w_ in zip((single, *pair), (want[0], *want)):
        np.testing.assert_allclose(got.detach().numpy(), w_, rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad((single ** 2).sum(), [u, it, w, tb1, tw2, tb2])
    duser, ditems, dku, dki, db1, dk2, db2 = (np.asarray(g) for g in want_grads)
    want_torch = [duser, ditems, np.concatenate([dku.T, dki.T], axis=1), db1, dk2.T, db2]
    for name, g, w_ in zip(("user", "items", "fc1", "b1", "w2", "b2"), got, want_torch):
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-4, atol=1e-5, err_msg=name)
    # the pair's gradients are both users' terms: the same as two single calls
    pair_grads = torch.autograd.grad(sum((x ** 2).sum() for x in pair), leaves[2:])
    two = torch.autograd.grad(sum((scoring.scoring_head_plain(x, it, *params) ** 2).sum()
                                  for x in (u, o)), leaves[2:])
    for g, w_ in zip(pair_grads, two):
        torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-5)
    # the wrappers take the plain versions on CPU tensors at every width
    with torch.no_grad():
        assert torch.equal(scoring.scoring_head(u, it, *params), single.detach())


# ---------------------------------------------------------------------------
# a configuration-(c)-shaped model: BERT4Rec at dh=256, pairwise, InterComp
# ---------------------------------------------------------------------------

B, T, D, VOCAB = 4, 6, 256, 50
LR, DR_E_W = 1e-3, 0.1
WIDE_KW = dict(backbone="bert4rec", emb_dim=D, bert_heads=1, bert_blocks=1, bert_ff_dim=32,
               bert_dropout=0.0, hid_dim=8, seq_len=T, batch_size=B, is_itc=True, ts2=0.2,
               is_dr=True, comp_broadcast_quirk=False, item_length=VOCAB, user_length=VOCAB)
POOLS = np.tile(np.arange(2 * VOCAB, dtype=np.int32)[None], (2, 1))
POOL_SIZES = np.array([2 * VOCAB, 2 * VOCAB], np.int32)


def _batch(rng):
    """No history fully masked: there the port's additive key mask and the
    JAX XLA route's replaced one part (tests/test_torch_backbones.py)."""
    v = 2 * VOCAB
    return {"target": rng.integers(0, v, B).astype(np.int32),
            "neg_samples": rng.integers(0, v, (B, 1)).astype(np.int32),
            "seq_d1": rng.integers(1, v, (B, T)).astype(np.int32),
            "seq_d2": rng.integers(1, v, (B, T)).astype(np.int32),
            "domain_id": rng.integers(0, 2, B).astype(np.int32),
            "reject": np.full((B, 1), v, np.int32),
            "reject_counts": np.zeros(B, np.int32),
            "ob_label": rng.integers(0, 2, B).astype(np.int32)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_a_head_width_256_pairwise_model_matches_jax(rng):
    """The feature pass (the JAX model through its Pallas affinity kernel in
    interpret mode, the port built with kernels='cuda', whose wrappers take
    their plain versions on CPU tensors) and one phase-A step (the JAX model
    on XLA, the port's affinity fp32: JAX cannot differentiate through its
    small-N kernel) from the same weights, batch and negatives: losses,
    parameters and moments."""
    jmodel = jax_build_model(JaxModelConfig(**WIDE_KW, kernels="force_pallas"))
    batch = _batch(rng)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    with pltpu.force_tpu_interpret_mode():
        params = jax.jit(functools.partial(jmodel.init, train=False))(
            {"params": key, "dropout": key}, jb)["params"]
        want = jax_user_representations(jmodel, params,
                                        {k: jb[k] for k in ("seq_d1", "seq_d2")})
    port = AMIDModel(ModelConfig(**WIDE_KW, kernels="cuda"))
    assert head_width(port.cfg) == 256 and port.cfg.enc_seq_len == 2 * T
    port.load_state_dict(params_from_flax(_np_tree(params)), strict=True)
    port.eval()
    got = user_representations(port, {k: batch[k] for k in ("seq_d1", "seq_d2")})
    for g, w in zip(got, want):
        assert tuple(g.shape) == (B, D)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)

    jmodel = jax_build_model(JaxModelConfig(**WIDE_KW, kernels="xla"))
    for name in ("itc_d1", "itc_d2"):
        getattr(port, name).message.affinity = max_affinity_xla
    tx = optax.adam(LR)
    jstate = jax_steps.TrainState(params, tx.init(params), optax.adam(LR).init(params))
    parts = (np.asarray(jstate.opt_state[0].count), _np_tree(jstate.opt_state[0].mu),
             _np_tree(jstate.opt_state[0].nu))
    state = steps.TrainState(dict(port.named_parameters()), adam_state_from_optax(*parts),
                             adam_state_from_optax(*parts))
    jp, jps = jnp.asarray(POOLS), jnp.asarray(POOL_SIZES)
    step_key = jax.random.PRNGKey(1)
    neg = np.array(jax_sample_negatives(jax.random.split(step_key, 4)[0], jp, jps,
                                        jb["domain_id"], jb["reject"], 1, jb["reject_counts"]))
    step_batch = {k: v for k, v in batch.items() if k != "neg_samples"}
    jstate, jm = jax_steps.make_train_step(jmodel, tx, dr_e_w=DR_E_W)(
        jstate, {k: jnp.asarray(v) for k, v in step_batch.items()}, jp, jps, step_key)
    state, m = steps.make_train_step(port, Adam(LR), dr_e_w=DR_E_W)(
        state, {k: torch.as_tensor(v) for k, v in step_batch.items()},
        torch.as_tensor(POOLS), torch.as_tensor(POOL_SIZES), 0, neg=neg)
    assert m.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=ATOL, rtol=RTOL, err_msg=k)
    # the gradients, as Adam's first moment after one step holds them (0.1
    # g): the updated parameters are lr g / (|g| + eps), which turns a
    # gradient at rounding level into a step of either sign (chip_smoke.py's
    # UPDATE_ATOL), so they are compared only where |g| >= 1e-6
    grads = {k: v.detach().numpy() / 0.1 for k, v in state.opt_state.mu.items()}
    want = {k: v.numpy() / 0.1 for k, v in params_from_flax(
        _np_tree(jstate.opt_state[0].mu)).items()}
    want_params = params_from_flax(_np_tree(jstate.params))
    assert grads.keys() == want.keys() == state.params.keys() == want_params.keys()
    for k, w in want.items():
        np.testing.assert_allclose(grads[k], w, atol=ATOL, rtol=RTOL, err_msg=f"d{k}")
        resolved = np.abs(w) >= 1e-6
        np.testing.assert_allclose(state.params[k].detach().numpy()[resolved],
                                   want_params[k].numpy()[resolved], atol=ATOL, rtol=RTOL,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# check_kernels_fit
# ---------------------------------------------------------------------------

CONFIG_C = dict(backbone="bert4rec", emb_dim=1024, seq_len=150, is_itc=True,
                comp_broadcast_quirk=False)


def test_check_kernels_fit_takes_configuration_c(kernel_limits):  # noqa: F811
    """BERT4Rec at --emb_dim 1024 (dh=256, encoder T=300), pairwise, and the
    same in quirk mode and at T=20."""
    cfg = ModelConfig(**CONFIG_C)
    assert head_width(cfg) == 256 and cfg.enc_seq_len == 300
    check_kernels_fit(cfg)
    check_kernels_fit(ModelConfig(**{**CONFIG_C, "comp_broadcast_quirk": True}))
    check_kernels_fit(ModelConfig(**{**CONFIG_C, "seq_len": 20}))


@pytest.mark.parametrize("overrides", [
    dict(use_bf16=True),  # configuration (c) under --bf16: dh=256 on the bf16 long pair
    dict(use_bf16=True, hid_dim=64),  # configuration (d)
    dict(backbone="gru4rec", emb_dim=1026, comp_broadcast_quirk=True),  # D not a multiple of 4
    dict(backbone="gru4rec", emb_dim=1408),  # K5's wide kernel: Wi^T beyond a block
    dict(backbone="gru4rec", emb_dim=1024, hid_dim=64),
    dict(backbone="gru4rec", emb_dim=2048, comp_broadcast_quirk=True),
])
def test_check_kernels_fit_takes_the_widths_the_kernels_take(kernel_limits,  # noqa: F811
                                                              overrides):
    """What waited before the bf16 long pair took head width 256 and K5 any
    D and H: each runs on kernels='cuda' with no refusal."""
    check_kernels_fit(ModelConfig(**{**CONFIG_C, **overrides}))


@pytest.mark.parametrize("overrides,words", [
    (dict(emb_dim=1056), ("dh=264", "head widths 1 to 256", "T<=")),  # dh above 256
    (dict(emb_dim=1056, use_bf16=True), ("dh=264", "head widths 1 to 256 (fp32 and bf16)")),
    (dict(seq_len=2 ** 22, is_itc=False),  # dh=256: the long backward's 64-row blocks
     ("T=4194304", "T<=4194240")),
    (dict(seq_len=2 ** 22, is_itc=False, use_bf16=True),  # the bf16 dK/dV kernel's 64 rows
     ("T=4194304", "T<=4194240")),
    (dict(backbone="gru4rec", emb_dim=65540), ("affinity kernels take D from 1 to 65536",)),
])
def test_check_kernels_fit_refuses_what_waits(kernel_limits, overrides, words):  # noqa: F811
    """Each shape that no kernel of a kernels='cuda' model takes is refused
    before any forward, naming its limit and --kernels torch: a head above
    256 in either mode, a T beyond the long backward's 64-row blocks at
    dh=256 (the fp32 pair's and the bf16 dK/dV kernel's), a pairwise
    affinity row above 65,536 columns."""
    cfg = ModelConfig(**{**CONFIG_C, **overrides})
    with pytest.raises(ValueError) as err:
        check_kernels_fit(cfg)
    for part in (*words, "--kernels torch"):
        assert part in str(err.value), part


# ---------------------------------------------------------------------------
# a configuration-(d)-shaped model: configuration (c)'s under use_bf16
# ---------------------------------------------------------------------------

BF16_KW = dict(backbone="bert4rec", emb_dim=256, bert_heads=1, bert_ff_dim=32,
               bert_dropout=0.0, hid_dim=12, seq_len=6, batch_size=8, is_itc=True, ts2=0.12,
               is_dr=True, comp_broadcast_quirk=False, item_length=50, user_length=50,
               use_bf16=True)


def test_a_head_width_256_bf16_pairwise_model_matches_jax(rng):
    """BERT4Rec with one head of 256, pairwise InterComp, the DR heads at
    hid_dim 12 (K5's wide kernel's shape class on the card) and
    `use_bf16=True`: outputs and every leaf's gradient against the JAX
    model built with `use_bf16=True` (fp32 on this CPU) at
    `test_torch_precision.py`'s bf16 tolerances (BF16_OUT_TOL,
    BF16_GRAD_TOL, BF16_LEAF_TOL). Both sides take the affinity in fp32
    (JAX's XLA route), so a gate does not flip on the bf16 inputs of the
    port's K6/K7; no history is fully masked (there the port's additive key
    mask and JAX's XLA route part)."""
    jcfg = JaxModelConfig(**BF16_KW, kernels="xla")
    jmodel = jax_build_model(jcfg)
    b, t, v = BF16_KW["batch_size"], BF16_KW["seq_len"], 2 * BF16_KW["item_length"]
    batch = {"seq_d1": rng.integers(1, v, (b, t)).astype(np.int32),
             "seq_d2": rng.integers(1, v, (b, t)).astype(np.int32),
             "target": rng.integers(0, v, b).astype(np.int32),
             "neg_samples": rng.integers(0, v, (b, 3)).astype(np.int32)}
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "dropout": key},
                         {k: jnp.asarray(x) for k, x in batch.items()}, train=False)["params"]
    port = AMIDModel(ModelConfig(**BF16_KW, kernels="cuda"))
    assert head_width(port.cfg) == 256 and port.precision == "bf16"
    port.load_state_dict(params_from_flax(_np_tree(params)), strict=True)
    for name in ("itc_d1", "itc_d2"):
        getattr(port, name).message.affinity = max_affinity_xla
    weights = _weights(rng)
    for k in OUT_KEYS:  # this width's outputs
        if not k.startswith(("logits", "ips", "gfunc")):
            weights[k] = rng.normal(size=(b, BF16_KW["emb_dim"])).astype(np.float32)
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
    assert np.sqrt(diff) <= BF16_GRAD_TOL * np.sqrt(ref_norm)
    fp32 = AMIDModel(ModelConfig(**{**BF16_KW, "use_bf16": False}, kernels="cuda"))
    fp32.load_state_dict(port.state_dict())
    with torch.no_grad():
        assert (fp32(batch)["logits_d1"] - port(batch)["logits_d1"]).abs().max() > 1e-6
