"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. This file imports
no JAX, so it runs on a machine without it; from the repository root:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import ctypes
import dataclasses
import importlib.util
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from amid_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from amid_tpu_torch.data.sampler import sample_negatives
from amid_tpu_torch.data.synthetic import synth_packed
from amid_tpu_torch.models.amid import build_model
from amid_tpu_torch.ops import launches
from amid_tpu_torch.ops import affinity as affinity_ops
from amid_tpu_torch.ops.affinity import (
    affinity_smem_bytes,
    blocked_plan,
    max_affinity,
    max_affinity_blocked,
    max_affinity_plain,
    max_affinity_smalln,
    smalln_plan,
)
from amid_tpu_torch.ops import attention as attention_ops
from amid_tpu_torch.ops.attention import (
    attention_backward,
    attention_bwd_plain,
    attention_fwd_stats_plain,
    attention_fwd_stats_streamed_plain,
    attention_plain,
    dropout_keep_mask,
    forward_route,
    fused_attention,
)
from amid_tpu_torch.ops import embedding as embedding_ops
from amid_tpu_torch.ops import scatter as scatter_ops
from amid_tpu_torch.ops.embedding import (
    embedding_gather,
    embedding_gather_grad,
    embedding_gather_grad_ordered,
    embedding_gather_grad_plain,
    embedding_gather_many,
    embedding_gather_many_plain,
    embedding_gather_plain,
)
from amid_tpu_torch.ops.scatter import (
    scatter_set_unique,
    scatter_set_unique3,
    scatter_set_unique3_plain,
    scatter_set_unique_plain,
)
from amid_tpu_torch.ops import scoring as scoring_ops
from amid_tpu_torch.ops.scoring import (
    scoring_head,
    scoring_head_pair,
    scoring_head_pair_plain,
    scoring_head_plain,
)
from amid_tpu_torch.ops.rng import StepRandom, fold_in
from amid_tpu_torch.serve import user_representations
from amid_tpu_torch.train import lazy, loop, steps
from amid_tpu_torch.train.checkpoint import CheckpointManager, state_leaves
from amid_tpu_torch.train.graphs import GraphPool, StepGraph
from amid_tpu_torch.train.optim import Adam

pytestmark = pytest.mark.cuda
ATOL, RTOL = 1e-5, 1e-4  # fp32 kernel vs fp32 plain, sums in another order
BWD_ATOL = 2e-5  # backward: dk, dv sum products over up to T queries
# the long forward's row statistics vs plain (chip_smoke.py's LONG_STATS_ATOL):
# its scores are wgmma's fp32 sums of 3xTF32 products
LONG_MAX_ATOL, LONG_INV_SUM_ATOL = 1.2e-5, 2e-6


def _bwd_atol(t):
    """chip_smoke.py's `bwd_atol` below dh=64 (where it starts from 5e-5):
    dk and dv sum one term a query, each with the cancellation error of
    dP - D in rows with few kept keys; 2e-5 up to T=150, growing with T
    beyond. Held here at every head width."""
    return BWD_ATOL * max(1.0, t / 150)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _bias(kind, b, t, gen):
    if kind == "causal":
        return torch.triu(torch.full((t, t), -1e9, device="cuda"), diagonal=1)[None, None]
    if kind == "keypad":  # [B, 1, 1, T], row 0 fully masked
        lens = torch.randint(1, t + 1, (b,), device="cuda", generator=gen)
        ok = torch.arange(t, device="cuda")[None, :] >= (t - lens[:, None])
        ok[0] = False
        return torch.where(ok, 0.0, -1e9)[:, None, None, :]
    if kind == "per_query":  # [B, 1, T, T]
        return torch.randn(b, 1, t, t, device="cuda", generator=gen)
    return torch.zeros(1, 1, 1, t, device="cuda")


@pytest.mark.parametrize("t,d,heads,kind", [
    (150, 128, 8, "causal"), (20, 128, 8, "causal"), (150, 128, 4, "keypad"),
    (7, 64, 8, "per_query"), (33, 128, 2, "zeros"), (300, 32, 4, "causal"),
    # dh 12 (template 16), and 128 below its crossover (`LONG_FWD_FASTER_FROM`)
    (150, 96, 8, "causal"), (20, 512, 4, "keypad"),
])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_kernel_matches_plain(gen, t, d, heads, kind, rate):
    b = 16
    q, k, v = (torch.randn(b, t, d, device="cuda", generator=gen) for _ in range(3))
    bias = _bias(kind, b, t, gen)
    before = fused_attention.launches
    got = fused_attention(q, k, v, bias, 123, heads, rate)
    assert fused_attention.launches == before + 1
    want = attention_plain(q, k, v, bias, 123, heads, rate)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_kernel_reads_strided_inputs(gen):
    """q, k, v as column slices of one [B, T, 3D] projection."""
    b, t, d, heads = 8, 40, 128, 8
    qkv = torch.randn(b, t, 3 * d, device="cuda", generator=gen)
    q, k, v = qkv.split(d, dim=-1)
    bias = _bias("causal", b, t, gen)
    torch.testing.assert_close(fused_attention(q, k, v, bias, 0, heads, 0.0),
                               attention_plain(q, k, v, bias, 0, heads, 0.0),
                               atol=ATOL, rtol=RTOL)


def test_kernel_dropout_mask_equals_plain_mask(gen):
    """One-hot values read the kept probabilities out of the kernel."""
    b, t, d, heads, seed = 32, 20, 128, 4, 5
    dh = d // heads
    q, k = (torch.randn(b, t, d, device="cuda", generator=gen) for _ in range(2))
    v = torch.zeros(b, t, d, device="cuda")
    for h in range(heads):
        v[:, torch.arange(t), h * dh + torch.arange(t)] = 1.0
    out = fused_attention(q, k, v, _bias("zeros", b, t, gen), seed, heads, 0.5)
    got = out.view(b, t, heads, dh)[..., :t].permute(0, 2, 1, 3) != 0
    assert torch.equal(got, dropout_keep_mask(seed, b, heads, t, 0.5, "cuda"))


@pytest.mark.parametrize("t,d,heads,kind", [
    (150, 128, 8, "causal"), (20, 128, 8, "causal"), (150, 128, 4, "keypad"),
    (7, 64, 8, "per_query"), (33, 128, 2, "zeros"), (200, 32, 4, "causal"),
    (150, 96, 8, "causal"), (64, 512, 4, "keypad"),  # dh 12 and 128 (T <= 80 fits)
])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_backward_kernel_matches_plain(gen, t, d, heads, kind, rate):
    """The one-sweep kernel (asked for by name: `backward_route` sends
    T=150 at dh=32 to the long path); the keypad case masks every key of
    batch row 0; above dh=64 the tolerance is chip_smoke.py's `bwd_atol`."""
    b = 16
    q, k, v, dout = (torch.randn(b, t, d, device="cuda", generator=gen) for _ in range(4))
    bias = _bias(kind, b, t, gen)
    res = attention_fwd_stats_plain(q, k, v, bias, 123, heads, rate)
    before = fused_attention.backward_launches
    got = attention_backward(q, k, v, bias, *res, dout, 123, heads, rate, path="sweep")
    assert fused_attention.backward_launches == before + 1
    want = attention_bwd_plain(q, k, v, bias, *res, dout, 123, heads, rate)
    atol = _chip_smoke().bwd_atol(t, d // heads) if d // heads > 64 else BWD_ATOL
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=atol, rtol=RTOL)


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_backward_kernel_is_bit_equal_across_calls(gen, rate):
    """No float atomics: every sum is taken in an order fixed by the tiles."""
    b, t, d, heads = 32, 150, 128, 8
    q, k, v, dout = (torch.randn(b, t, d, device="cuda", generator=gen) for _ in range(4))
    bias = _bias("causal", b, t, gen)
    res = attention_fwd_stats_plain(q, k, v, bias, 5, heads, rate)
    first = attention_backward(q, k, v, bias, *res, dout, 5, heads, rate)
    for _ in range(3):
        again = attention_backward(q, k, v, bias, *res, dout, 5, heads, rate)
        for x, y in zip(first, again):
            assert torch.equal(x, y)


@pytest.mark.parametrize("t,kind", [(150, "causal"), (150, "keypad"), (20, "causal"), (33, "zeros")])
def test_forward_row_statistics_match_plain(gen, t, kind):
    """The forward kernel under autograd writes row_max and row_inv_sum equal
    to the plain version's (fully masked row included)."""
    b, d, heads = 16, 128, 8
    q, k, v = (torch.randn(b, t, d, device="cuda", generator=gen) for _ in range(3))
    bias = _bias(kind, b, t, gen)
    out, row_max, row_inv_sum = attention_ops._launch_forward(q, k, v, bias, 0, heads, 0.0, True)
    want = attention_fwd_stats_plain(q, k, v, bias, 0, heads, 0.0)
    torch.testing.assert_close(out, want[0], atol=ATOL, rtol=RTOL)
    # 1e-6 relative, and 1e-6 absolute for a max near 0 (scores agree to ~5e-7)
    torch.testing.assert_close(row_max, want[1], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(row_inv_sum, want[2], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_long_backward_matches_plain_at_bert4rec_s_t600(gen, rate):
    """The long-sequence path at dh=32, T=600 (BERT4Rec's encoder with
    InnerComp and InterComp at T=150), batch row 0 fully masked: against the
    plain one-sweep arithmetic, and bit-equal over two calls."""
    b, t, d, heads = 8, 600, 128, 4
    assert attention_ops.backward_route(t, d // heads) == "long"
    q, k, v, dout = (torch.randn(b, t, d, device="cuda", generator=gen) for _ in range(4))
    bias = _bias("keypad", b, t, gen)
    seed = torch.tensor([31], dtype=torch.int64, device="cuda")
    res = attention_fwd_stats_plain(q, k, v, bias, seed, heads, rate)
    before = (fused_attention.backward_launches, fused_attention.long_backward_launches)
    got = attention_backward(q, k, v, bias, *res, dout, seed, heads, rate)
    again = attention_backward(q, k, v, bias, *res, dout, seed, heads, rate)
    assert (fused_attention.backward_launches,
            fused_attention.long_backward_launches) == (before[0], before[1] + 2)
    want = attention_bwd_plain(q, k, v, bias, *res, dout, seed, heads, rate)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, atol=_bwd_atol(t), rtol=RTOL)


@pytest.mark.parametrize("t,d,heads,kind", [(300, 128, 4, "keypad"), (150, 128, 8, "causal"),
                                            (37, 64, 8, "per_query"), (70, 128, 2, "keypad")])
def test_both_backward_paths_match_plain_where_both_take_the_shape(gen, t, d, heads, kind):
    """At T=300 (dh=32) and T=150 (dh=16) both paths run: each against the
    plain version, the long path bit-equal over two calls; every head width."""
    b = 8
    q, k, v, dout = (torch.randn(b, t, d, device="cuda", generator=gen) for _ in range(4))
    bias = _bias(kind, b, t, gen)
    res = attention_fwd_stats_plain(q, k, v, bias, 5, heads, 0.5)
    want = attention_bwd_plain(q, k, v, bias, *res, dout, 5, heads, 0.5)
    for path in ("sweep", "long"):
        got = attention_backward(q, k, v, bias, *res, dout, 5, heads, 0.5, path=path)
        again = attention_backward(q, k, v, bias, *res, dout, 5, heads, 0.5, path=path)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, a), path
            torch.testing.assert_close(g, w, atol=_bwd_atol(t), rtol=RTOL)


def test_gradient_through_the_long_path_of_the_autograd_function(gen):
    """A forward under autograd at T=600 (dh=32) launches the forward kernel
    and, for the gradient, the long path; gradients equal autograd of the
    plain version."""
    b, t, d, heads = 2, 600, 128, 4
    qkv = torch.randn(b, t, 3 * d, device="cuda", generator=gen, requires_grad=True)
    bias = _bias("keypad", b, t, gen)
    longs = fused_attention.long_backward_launches
    out = fused_attention(*qkv.split(d, dim=-1), bias, 3, heads, 0.1)
    (got,) = torch.autograd.grad((out ** 2).sum(), qkv)
    assert fused_attention.long_backward_launches == longs + 1
    ref = attention_plain(*qkv.split(d, dim=-1), bias, 3, heads, 0.1)
    (want,) = torch.autograd.grad((ref ** 2).sum(), qkv)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_kernels_at_the_largest_supported_t(gen):
    """The longest sequence each kernel takes at dh=16 (its shared memory),
    padded to its tiles, against the plain versions."""
    limit = attention_ops.SMEM_LIMIT
    fused_attention(*(torch.zeros(1, 8, 16, device="cuda") for _ in range(3)),
                    _bias("zeros", 1, 8, gen), 0, 1, 0.0)  # binds the entry points
    t_fwd = max(n for n in range(1, 2000) if attention_ops._fwd_smem["fp32"](n, 16) <= limit)
    t_bwd = max(n for n in range(1, 2000) if attention_ops._bwd_smem["fp32"](n, 16) <= limit)
    for t, backward in ((t_fwd, False), (t_bwd, True)):
        b, d, heads = 2, 64, 4
        q, k, v, dout = (torch.randn(b, t, d, device="cuda", generator=gen) for _ in range(4))
        bias = _bias("causal", b, t, gen)
        res = attention_fwd_stats_plain(q, k, v, bias, 11, heads, 0.5)
        if backward:
            got = attention_backward(q, k, v, bias, *res, dout, 11, heads, 0.5, path="sweep")
            want = attention_bwd_plain(q, k, v, bias, *res, dout, 11, heads, 0.5)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, atol=BWD_ATOL, rtol=RTOL)
        else:  # the one-head kernel by name: the route sends this T to the long forward
            with torch.no_grad():
                got = attention_ops._launch_forward(q, k, v, bias, 11, heads, 0.5, False,
                                                    "sweep")[0]
            torch.testing.assert_close(got, res[0], atol=ATOL, rtol=RTOL)


def test_no_grad_forward_makes_no_function_and_no_statistics(gen, monkeypatch):
    b, t, d, heads = 4, 20, 128, 8
    q, k, v = (torch.randn(b, t, d, device="cuda", generator=gen, requires_grad=True)
               for _ in range(3))
    asked = []
    launch = attention_ops._launch_forward
    monkeypatch.setattr(attention_ops, "_launch_forward",
                        lambda *a, **kw: asked.append(a[-1]) or launch(*a, **kw))
    with torch.no_grad():
        out = fused_attention(q, k, v, _bias("causal", b, t, gen), 0, heads, 0.0)
    assert out.grad_fn is None and asked == [False]
    out = fused_attention(q, k, v, _bias("causal", b, t, gen), 0, heads, 0.0)
    assert type(out.grad_fn).__name__ == "_FusedAttentionBackward" and asked == [False, True]


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_gradient_through_the_autograd_function(gen, rate):
    """Forward and backward kernels joined: gradients of a scalar loss equal
    autograd of the plain version, with q, k, v column slices of one
    projection (strided) and the same seed in both directions."""
    b, t, d, heads = 8, 40, 128, 8
    qkv = torch.randn(b, t, 3 * d, device="cuda", generator=gen, requires_grad=True)
    bias = _bias("causal", b, t, gen)
    fwd, bwd = fused_attention.launches, fused_attention.backward_launches
    out = fused_attention(*qkv.split(d, dim=-1), bias, 9, heads, rate)
    (got,) = torch.autograd.grad((out ** 2).sum(), qkv)
    assert (fused_attention.launches, fused_attention.backward_launches) == (fwd + 1, bwd + 1)
    ref = attention_plain(*qkv.split(d, dim=-1), bias, 9, heads, rate)
    (want,) = torch.autograd.grad((ref ** 2).sum(), qkv)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    with torch.no_grad():  # no graph: only the forward kernel runs
        fused_attention(*qkv.split(d, dim=-1), bias, 9, heads, rate)
    assert fused_attention.backward_launches == bwd + 1


def test_backward_rejects_sequences_its_tile_cannot_hold(gen):
    """T=800 at dh=16 fits the forward's shared memory (K, V) but not the
    one-sweep backward's (Q, dO, K, dQ): that kernel refuses it and names the
    largest T, and a gradient takes the long path instead."""
    q = torch.randn(1, 800, 64, device="cuda", generator=gen, requires_grad=True)
    bias = _bias("zeros", 1, 800, gen)
    x = q.detach()
    stats = torch.zeros(1, 4, 800, device="cuda")
    before = fused_attention.backward_launches
    with pytest.raises(ValueError, match="shared memory.*largest T"):
        attention_backward(x, x, x, bias, x, stats, stats, x, 0, 4, 0.0, path="sweep")
    assert fused_attention.backward_launches == before
    assert attention_ops.backward_route(800, 16) == "long"
    longs = fused_attention.long_backward_launches
    out = fused_attention(q, q, q, bias, 0, 4, 0.0)
    torch.autograd.grad(out.sum(), q)
    assert fused_attention.long_backward_launches == longs + 1
    with pytest.raises(ValueError, match="limit of T="):
        attention_ops._check_backward_fits(attention_ops.long_backward_max_t() + 1, 16)


# dh 8, 16, 32, 64; 12 (template 16), 6 (template 8, rows not on 16 bytes), 128
LONG_WIDTHS = [(16, 128), (8, 128), (4, 128), (2, 128), (8, 96), (4, 24), (1, 128)]


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("t,kind", [(369, "causal"), (601, "keypad"), (1000, "per_query")])
@pytest.mark.parametrize("heads,d", LONG_WIDTHS)
def test_long_path_at_every_head_width_and_ragged_t(gen, heads, d, t, kind, rate):
    """The long path against the plain version at each head width, at T that
    are no multiple of its 64- or 128-row tiles, every bias form (key padding
    with batch row 0 fully masked), with q, k, v column slices of one
    projection: bit-equal over two calls, one launch counted per call."""
    b = 2
    qkv = torch.randn(b, t, 3 * d, device="cuda", generator=gen)
    q, k, v = qkv.split(d, dim=-1)
    dout = torch.randn(b, t, d, device="cuda", generator=gen)
    bias = _bias(kind, b, t, gen)
    seed = torch.tensor([77], dtype=torch.int64, device="cuda")
    res = attention_fwd_stats_plain(q, k, v, bias, seed, heads, rate)
    before = (fused_attention.backward_launches, fused_attention.long_backward_launches)
    got = attention_backward(q, k, v, bias, *res, dout, seed, heads, rate, path="long")
    again = attention_backward(q, k, v, bias, *res, dout, seed, heads, rate, path="long")
    assert (fused_attention.backward_launches,
            fused_attention.long_backward_launches) == (before[0], before[1] + 2)
    want = attention_bwd_plain(q, k, v, bias, *res, dout, seed, heads, rate)
    atol = _chip_smoke().bwd_atol(t, d // heads) if d // heads > 64 else _bwd_atol(t)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, atol=atol, rtol=RTOL)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("t,kind", [(37, "keypad"), (130, "causal"), (601, "keypad"),
                                    (1000, "per_query"), (200, "keypad"), (100, "per_query")])
@pytest.mark.parametrize("heads,d", LONG_WIDTHS)
def test_long_forward_at_every_head_width_and_ragged_t(gen, heads, d, t, kind, rate):
    """The long forward against its plain version in key tiles at each head
    width, at T that are no multiple of its 128-row blocks or key stages,
    every bias form (key padding with batch row 0 fully masked), with q, k,
    v column slices of one projection (at dh=128 both sides of the in-block
    cut: one query block a head, two with key padding, two with a
    per-query bias, more): out and the row statistics, bit-equal over two
    calls, one launch counted per call."""
    b = 2
    q, k, v = torch.randn(b, t, 3 * d, device="cuda", generator=gen).split(d, dim=-1)
    bias = _bias(kind, b, t, gen)
    seed = torch.tensor([77], dtype=torch.int64, device="cuda")
    before = (fused_attention.launches, fused_attention.long_forward_launches)
    got = attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, True, "long")
    again = attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, True, "long")
    assert (fused_attention.launches,
            fused_attention.long_forward_launches) == (before[0], before[1] + 2)
    want = attention_fwd_stats_streamed_plain(q, k, v, bias, seed, heads, rate,
                                              32 if d // heads > 32 else 64)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    torch.testing.assert_close(got[0], want[0], atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got[1], want[1], atol=LONG_MAX_ATOL, rtol=1e-6)
    torch.testing.assert_close(got[2], want[2], atol=LONG_INV_SUM_ATOL, rtol=1e-6)


@pytest.mark.parametrize("t", [601, 200])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["causal", "keypad"])
@pytest.mark.parametrize("heads,d", LONG_WIDTHS)
def test_long_forward_with_a_row_offset_feeds_the_long_backward(gen, heads, d, kind, rate, t):
    """At every template width and two padded ones (dh 12 and 6), both
    biases, rates 0 and 0.1, T of 601 and 200 (at dh=128 the in-block kernel
    with key padding), and a batch that starts at global row 3 (a
    data-parallel rank's dropout rows): the long forward against its plain
    version in key tiles with the same row offset, and its statistics fed
    to the long backward give the gradients of the plain forward's."""
    b, offset = 2, 3
    q, k, v = torch.randn(b, t, 3 * d, device="cuda", generator=gen).split(d, dim=-1)
    dout = torch.randn(b, t, d, device="cuda", generator=gen)
    bias = _bias(kind, b, t, gen)
    seed = torch.tensor([91], dtype=torch.int64, device="cuda")
    dh = d // heads
    got = attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, True, "long",
                                        row_offset=offset)
    want = attention_fwd_stats_streamed_plain(q, k, v, bias, seed, heads, rate,
                                              32 if dh > 32 else 64, row_offset=offset)
    torch.testing.assert_close(got[0], want[0], atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got[1], want[1], atol=LONG_MAX_ATOL, rtol=1e-6)
    torch.testing.assert_close(got[2], want[2], atol=LONG_INV_SUM_ATOL, rtol=1e-6)
    grads = attention_backward(q, k, v, bias, *got, dout, seed, heads, rate, path="long",
                               row_offset=offset)
    plain = attention_bwd_plain(q, k, v, bias, *attention_fwd_stats_plain(
        q, k, v, bias, seed, heads, rate, row_offset=offset), dout, seed, heads, rate,
        row_offset=offset)
    atol = _chip_smoke().bwd_atol(t, dh) if dh > 64 else _bwd_atol(t)
    for g, w in zip(grads, plain):
        torch.testing.assert_close(g, w, atol=atol, rtol=RTOL)


@pytest.mark.parametrize("heads,d", [(4, 128), (2, 128), (1, 128), (8, 96)])  # dh 32 64 128 12
def test_long_forward_replayed_in_a_cuda_graph_equals_the_eager_call(gen, heads, d):
    """One long forward captured in a CUDA graph (after an eager call at the
    same shape: the shared-memory opt-in is not a stream operation) and
    replayed gives the eager call's bits; a new seed written into the seed
    tensor between replays changes the mask as the eager call does."""
    b, t = 4, 1200
    q, k, v = (torch.randn(b, t, d, device="cuda", generator=gen) for _ in range(3))
    bias = _bias("keypad", b, t, gen)
    seed = torch.tensor([5], dtype=torch.int64, device="cuda")
    eager = attention_ops._launch_forward(q, k, v, bias, seed, heads, 0.1, True, "long")
    longs = fused_attention.long_forward_launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = attention_ops._launch_forward(q, k, v, bias, seed, heads, 0.1, True, "long")
    assert fused_attention.long_forward_launches == longs + 1  # counted at the capture
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(captured, eager))
    seed.fill_(6)
    graph.replay()
    other = attention_ops._launch_forward(q, k, v, bias, 6, heads, 0.1, True, "long")
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(captured, other))
    assert not torch.equal(captured[0], eager[0])


def test_gradient_through_the_long_forward_of_the_autograd_function(gen):
    """Past the one-head kernel's limit (dh=64: T=424) the autograd function
    launches the long forward and, with its statistics, the long backward:
    gradients equal autograd of the plain version, dropout on."""
    b, t, d, heads = 2, 500, 128, 2
    qkv = torch.randn(b, t, 3 * d, device="cuda", generator=gen, requires_grad=True)
    bias = _bias("keypad", b, t, gen)
    assert forward_route(t, d // heads) == "long"
    before = (fused_attention.launches, fused_attention.long_forward_launches,
              fused_attention.long_backward_launches)
    out = fused_attention(*qkv.split(d, dim=-1), bias, 3, heads, 0.1)
    (got,) = torch.autograd.grad((out ** 2).sum(), qkv)
    assert (fused_attention.launches, fused_attention.long_forward_launches,
            fused_attention.long_backward_launches) == (before[0], before[1] + 1, before[2] + 1)
    ref = attention_plain(*qkv.split(d, dim=-1), bias, 3, heads, 0.1)
    (want,) = torch.autograd.grad((ref ** 2).sum(), qkv)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("heads,d", [(4, 128), (2, 128), (1, 128), (8, 96)])  # dh 32 64 128 12
def test_long_path_replayed_in_a_cuda_graph_equals_the_eager_call(gen, heads, d):
    """One long-path call captured in a CUDA graph (after an eager call at the
    same shape) and replayed gives the eager call's bits; a new seed written
    into the seed tensor between replays changes the mask, as the eager call
    with that seed does."""
    b, t = 4, 601
    q, k, v, dout = (torch.randn(b, t, d, device="cuda", generator=gen) for _ in range(4))
    bias = _bias("keypad", b, t, gen)
    seed = torch.tensor([5], dtype=torch.int64, device="cuda")
    res = attention_fwd_stats_plain(q, k, v, bias, seed, heads, 0.1)
    eager = attention_backward(q, k, v, bias, *res, dout, seed, heads, 0.1, path="long")
    longs = fused_attention.long_backward_launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = attention_backward(q, k, v, bias, *res, dout, seed, heads, 0.1, path="long")
    assert fused_attention.long_backward_launches == longs + 1  # counted at the capture
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(captured, eager))
    seed.fill_(6)
    graph.replay()
    other = attention_backward(q, k, v, bias, *res, dout, 6, heads, 0.1, path="long")
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(captured, other))
    assert not torch.equal(captured[2], eager[2])


@pytest.mark.parametrize("u,id_dtype", [(11264, torch.int32), (1000, torch.int64), (5, torch.int32)])
def test_scatter_kernels_match_plain_bit_for_bit(gen, u, id_dtype):
    v, d = 50_000, 128
    tabs = [torch.randn(v, d, device="cuda", generator=gen) for _ in range(3)]
    refs = [t.clone() for t in tabs]
    ids = torch.unique(torch.cat([torch.randperm(v, device="cuda", generator=gen)[: u - u // 5],
                                  torch.tensor([0, v - 1], device="cuda")]))[:u]
    ids = torch.cat([ids, torch.full((u - ids.numel(),), v, device="cuda")]).to(id_dtype)
    rows = [torch.randn(u, d, device="cuda", generator=gen) for _ in range(3)]
    n3, n1 = scatter_set_unique3.launches, scatter_set_unique.launches
    scatter_set_unique3(*tabs, ids, *rows)
    scatter_set_unique3_plain(*refs, ids, *rows)
    for a, b in zip(tabs, refs):
        assert torch.equal(a, b)
    scatter_set_unique(tabs[0], ids, rows[1])
    scatter_set_unique_plain(refs[0], ids, rows[1])
    assert torch.equal(tabs[0], refs[0])
    assert (scatter_set_unique3.launches, scatter_set_unique.launches) == (n3 + 1, n1 + 1)


def test_scatter_kernel_takes_unaligned_rows_and_3d_tables(gen):
    v, k, d, u = 300, 3, 20, 64
    table = torch.randn(v, k, d, device="cuda", generator=gen)
    ref = table.clone()
    ids = torch.cat([torch.randperm(v, device="cuda", generator=gen)[: u - 4],
                     torch.full((4,), v, device="cuda")]).to(torch.int32)
    rows = torch.randn(u, k, d, device="cuda", generator=gen)
    assert torch.equal(scatter_set_unique(table, ids, rows),
                       scatter_set_unique_plain(ref, ids, rows))
    flat, flat_ref = torch.zeros(v, 7, device="cuda"), torch.zeros(v, 7, device="cuda")
    src = torch.randn(u, 9, device="cuda", generator=gen)[:, 1:8]  # odd offset and stride
    assert torch.equal(scatter_set_unique(flat, ids, src),
                       scatter_set_unique_plain(flat_ref, ids, src))


def test_scatter_on_cuda_raises_on_what_it_does_not_take(gen):
    table = torch.zeros(8, 4, device="cuda")
    with pytest.raises(ValueError, match="on cuda"):
        scatter_set_unique(table, torch.tensor([1, 2]), torch.zeros(2, 4, device="cuda"))
    with pytest.raises(TypeError, match="float32"):
        scatter_set_unique(table.double(), torch.tensor([1], device="cuda"),
                           torch.zeros(1, 4, device="cuda").double())


def _unique_ids(gen, v, u, id_dtype, sentinels):
    """u ids: distinct rows of [0, v) with 0 and v-1 among them when there is
    room, then `sentinels` entries of v (dropped by the scatter)."""
    real = torch.randperm(v, device="cuda", generator=gen)[: u - sentinels]
    if real.numel() >= 2:
        real[:2] = torch.tensor([0, v - 1], device="cuda")
        real = torch.unique(real)
    ids = torch.cat([real, torch.full((u - real.numel(),), v, device="cuda")])
    return ids.to(id_dtype)


@pytest.mark.parametrize("u,id_dtype,sentinels", [
    (1, torch.int32, 0), (7, torch.int64, 2), (13, torch.int32, 13), (33, torch.int32, 1),
    (11_264, torch.int32, 1_126), (77_824, torch.int64, 7_782),
])
def test_scatter_row_loop_matches_plain_bit_for_bit(gen, u, id_dtype, sentinels):
    """The row loop, one and three arrays: batches of rows that
    end ragged (u no multiple of the 8 or 4 rows a warp takes), a batch of
    sentinels only, rows 0 and V-1, more rows than one pass of the grid."""
    v, d = 200_000, 128
    tabs = [torch.randn(v, d, device="cuda", generator=gen) for _ in range(3)]
    refs = [t.clone() for t in tabs]
    ids = _unique_ids(gen, v, u, id_dtype, sentinels)
    rows = [torch.randn(u, d, device="cuda", generator=gen) for _ in range(3)]
    scatter_set_unique3(*tabs, ids, *rows)
    scatter_set_unique3_plain(*refs, ids, *rows)
    for a, b in zip(tabs, refs):
        assert torch.equal(a, b)
    scatter_set_unique(tabs[0], ids, rows[2])
    scatter_set_unique_plain(refs[0], ids, rows[2])
    assert torch.equal(tabs[0], refs[0])
    # negative ids are dropped like the sentinel, a strided source is read in place
    wide = torch.randn(u, 2 * d, device="cuda", generator=gen)
    ids[::3] = -1
    scatter_set_unique(tabs[1], ids, wide[:, d:])
    scatter_set_unique_plain(refs[1], ids, wide[:, d:])
    assert torch.equal(tabs[1], refs[1])


def test_scatter_refusals_of_the_c_entry_point(gen):
    """Each code of `csrc/scatter_rows.cu` comes back as its exception."""
    table = torch.zeros(64, 8, device="cuda")
    ids = torch.arange(4, device="cuda")
    before = scatter_set_unique.launches
    with pytest.raises(ValueError, match="unit stride along the row"):  # -2
        scatter_set_unique(table, ids, torch.zeros(4, 16, device="cuda")[:, ::2])
    with pytest.raises(ValueError, match="share one shape"):
        scatter_set_unique3(table, table.clone(), torch.zeros(32, 8, device="cuda"), ids,
                            *[torch.zeros(4, 8, device="cuda")] * 3)
    assert scatter_set_unique.launches == before
    odd = torch.zeros(64, 7, device="cuda")
    scatter_set_unique(odd, ids, torch.ones(4, 7, device="cuda"))  # binds the entry point
    fn = scatter_ops._scatter_rows  # n_pairs, ids, ids64, U, V, width, device, stream | pairs
    assert fn(struct.pack("8q", 0, 0, 0, 4, 64, 8, 0, 0)) == -1  # no pair
    assert fn(struct.pack("12q", 1, 0, 0, -1, 64, 8, 0, 0, 0, 0, 8, 1)) == -1  # U < 0
    assert set(scatter_ops._REFUSALS) == {-1, -2}
    # a card that is not there: the query's cudaError comes back, nothing is guessed
    rows = torch.ones(4, 7, device="cuda")
    assert fn(struct.pack("12q", 1, ids.data_ptr(), 1, 4, 64, 7, 99, 0, odd.data_ptr(),
                          rows.data_ptr(), 7, 1)) > 0


@pytest.mark.parametrize("kind", ["dense", "lazy"])
def test_train_step_on_cuda_goes_through_the_kernels(gen, kind):
    cfg = ModelConfig(emb_dim=32, hid_dim=8, seq_len=12, batch_size=8, is_itc=True,
                      is_dr=True, item_length=50, user_length=50, sasrec_heads=2)
    model = build_model(cfg)
    v = cfg.item_table_size
    batch = {"target": torch.randint(0, v, (8,), device="cuda", generator=gen),
             "seq_d1": torch.randint(0, v, (8, 12), device="cuda", generator=gen),
             "seq_d2": torch.randint(0, v, (8, 12), device="cuda", generator=gen),
             "domain_id": torch.randint(0, 2, (8,), device="cuda", generator=gen),
             "reject": torch.full((8, 1), v, device="cuda"),
             "reject_counts": torch.zeros(8, dtype=torch.long, device="cuda"),
             "ob_label": torch.ones(8, dtype=torch.long, device="cuda")}
    pools = torch.arange(v, device="cuda").repeat(2, 1)
    sizes = torch.tensor([v, v], device="cuda")
    if kind == "dense":
        state = steps.init_state(model, Adam(1e-3))
        step = steps.make_train_step(model, Adam(1e-3), dr_e_w=0.1)
    else:
        state = lazy.init_lazy_state(dict(model.named_parameters()), Adam(1e-3))
        step = lazy.make_lazy_train_step(model, Adam(1e-3), dr_e_w=0.1)
    before = (fused_attention.launches, fused_attention.backward_launches,
              scatter_set_unique3.launches)
    _, m = step(state, batch, pools, sizes, 5)
    after = (fused_attention.launches, fused_attention.backward_launches,
             scatter_set_unique3.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (4, 4, int(kind == "lazy"))
    assert torch.isfinite(m["loss"]) and abs(float(m["loss_cls"]) - 0.693) < 0.05
    assert model.item_embedding.grad is None


def _backbone_cfg(backbone, **kw):
    """A small model of `backbone` whose attention takes a kernel head width:
    BERT4Rec with 2 heads of 32, GRU4Rec with hidden width 64."""
    return ModelConfig(**{**dict(backbone=backbone, emb_dim=64, hid_dim=16, seq_len=12,
                                 batch_size=8, is_itc=True, is_dr=True, item_length=50,
                                 user_length=50, bert_heads=2, bert_ff_dim=128), **kw})


def _step_batch(v, gen, bsz=8, t=12):
    return {"target": torch.randint(0, v, (bsz,), device="cuda", generator=gen),
            "seq_d1": torch.randint(0, v, (bsz, t), device="cuda", generator=gen),
            "seq_d2": torch.randint(0, v, (bsz, t), device="cuda", generator=gen),
            "domain_id": torch.randint(0, 2, (bsz,), device="cuda", generator=gen),
            "reject": torch.full((bsz, 1), v, device="cuda"),
            "reject_counts": torch.zeros(bsz, dtype=torch.long, device="cuda"),
            "ob_label": torch.ones(bsz, dtype=torch.long, device="cuda")}


@pytest.mark.parametrize("is_inc", [False, True], ids=["itc", "inc_itc"])
@pytest.mark.parametrize("backbone", ["bert4rec", "gru4rec"])
def test_backbone_phase_a_step_on_cuda_equals_the_plain_model_s(gen, backbone, is_inc):
    """One dense phase-A step of a kernels='cuda' model against the same step
    of a kernels='torch' model from the same weights, batch and key, dropout
    on (BERT4Rec's five sites draw from the step's generators on both); the
    BERT model's attention launches 4 forwards and 4 backwards, the GRU's
    none. User 0's domain-2 history is id 0 throughout: every key of its
    BERT rows is masked."""
    cfg = _backbone_cfg(backbone, is_inc=is_inc)
    model = build_model(cfg)
    plain = build_model(dataclasses.replace(cfg, kernels="torch"), device="cuda")
    plain.load_state_dict(model.state_dict())
    v = cfg.item_table_size
    batch = _step_batch(v, gen)
    batch["seq_d2"][0] = 0
    pools = torch.arange(v, device="cuda").repeat(2, 1)
    sizes = torch.tensor([v, v], device="cuda")
    metrics = []
    for m, want_attn in ((model, 4 * (backbone == "bert4rec")), (plain, 0)):
        state = steps.init_state(m, Adam(1e-3))
        step = steps.make_train_step(m, Adam(1e-3), dr_e_w=0.1)
        before = launches.read()
        _, out = step(state, batch, pools, sizes, 5)
        got = launches.since(before)
        assert got["attention_fwd"] == got["attention_bwd"] == want_attn
        metrics.append(out)
    for k, val in metrics[0].items():
        assert torch.isfinite(val) and abs(float(val) - float(metrics[1][k])) <= LOSS_TOL, k
    for (name, p), q in zip(model.named_parameters(), plain.parameters()):
        if name.endswith(".k.bias"):
            # its gradient is zero up to rounding (a constant added to every
            # key's score): Adam moves it by lr * sign(noise), not comparable
            continue
        torch.testing.assert_close(p, q, atol=1e-5, rtol=1e-4, msg=name)


def test_replayed_bert_steps_draw_new_dropout_masks_with_new_keys(gen):
    """BERT4Rec's dropout (the probabilities inside K1 and four sites around
    it) under a CUDA graph of the step: replays with different keys give
    different losses, and a replay with an eager step's key gives that
    step's loss (a mask drawn from the process-wide generator, or a seed
    frozen at capture, would repeat one mask on every replay)."""
    cfg = _backbone_cfg("bert4rec", bert_dropout=0.5)
    v = cfg.item_table_size
    batch = _step_batch(v, gen)
    pools = torch.arange(v, device="cuda").repeat(2, 1)
    sizes = torch.tensor([v, v], device="cuda")
    eager_model, graph_model = build_model(cfg, seed=0), build_model(cfg, seed=0)
    # a train-mode forward without the update, so each key starts from one state
    eval_loss = {}
    for name, m in (("eager", eager_model), ("graph", graph_model)):
        m.train()
        rng = StepRandom(None, "cuda")

        def body(m=m, rng=rng):
            with torch.no_grad():
                out = m({**batch, "neg_samples": batch["target"][:, None]}, rng=rng)
            return out["logits_d1"].sum() + out["logits_d2"].sum()

        eval_loss[name] = (body, rng)
    body, rng = eval_loss["graph"]
    pool = GraphPool("cuda")
    try:
        graph = StepGraph(body, rng.generators(), pool)
        got = {}
        for key in (1, 2, 3, 4):  # eager, capture + replay, replays
            rng.reseed(key)
            got[key] = float(graph())
        assert graph.replays == 3
        assert len(set(got.values())) == 4, got
        ebody, erng = eval_loss["eager"]
        for key in (2, 4):
            erng.reseed(key)
            assert abs(float(ebody()) - got[key]) <= 1e-4 * max(1.0, abs(got[key])), key
    finally:
        pool.close()


def test_gru_step_replays_equal_eager_steps(gen):
    """GRU4Rec's time loop inside a CUDA graph, with autograd through it:
    four dense phase-A steps through a resident chunk runner against the same
    steps taken eagerly."""
    cfg = _fast_cfg(backbone="gru4rec")
    ds = synth_packed(cfg, np.random.default_rng(0), 4 * FAST_BS)
    (_, est, estep), (_, gst, gstep) = _fast_pair("dense", "A", cfg)
    arrays = loop._resident(ds.batch_arrays(), "cuda")
    pools = loop._device_pools(ds, "cuda")
    perm = torch.as_tensor(np.random.default_rng(1).permutation(4 * FAST_BS).astype(np.int32),
                           device="cuda")
    pool = GraphPool("cuda")
    try:
        runner = steps.make_resident_chunk_runner(gstep, FAST_BS, pool)
        for i in range(4):
            _, m0, nf = runner(gst, arrays, perm, *pools, 9, range(i, i + 1), range(i, i + 1))
            rows = perm[i * FAST_BS:(i + 1) * FAST_BS]
            _, m = estep(est, {k: x.index_select(0, rows) for k, x in arrays.items()},
                         *pools, fold_in(9, i))
            assert float(nf) == 0.0
            for k, x in m0.items():
                assert abs(float(x) - float(m[k])) <= LOSS_TOL, (i, k)
        assert pool.graphs[0].replays == 3
        assert pool.graphs[0].captured["attention_fwd"] == 0
    finally:
        pool.close()


@pytest.mark.parametrize("d,heads,bf16,words", [
    (528, 2, False, "head widths 1 to 256"), (257, 1, False, "head widths 1 to 256"),
    (528, 2, True, "head widths 1 to 256"),
    (257, 1, True, "head widths 1 to 256")])  # dh 264, 257 in fp32 and in bf16
def test_kernel_rejects_unsupported_head_width(gen, d, heads, bf16, words):
    q = torch.randn(2, 8, d, device="cuda", generator=gen)
    with pytest.raises(ValueError, match=words):
        fused_attention(q, q, q, _bias("zeros", 2, 8, gen), 0, heads, 0.0, bf16)
    with pytest.raises(ValueError, match=words):
        attention_ops._launch_forward(q, q, q, _bias("zeros", 2, 8, gen), 0, heads, 0.0, False,
                                      "long", bf16=bf16)


@pytest.mark.parametrize("d,heads", [(272, 2), (129, 1), (256, 1)])  # dh 136, 129 and 256
@pytest.mark.parametrize("kind", ["causal", "keypad"])
def test_fp32_long_pair_takes_heads_above_128(gen, d, heads, kind):
    """Heads of 129 to 256 run on the fp32 long pair at template width 256
    (the padded build below 256), at every T: the forward and, through
    autograd, the backward against the plain versions, one launch each."""
    t, b = 37, 3
    q, k, v, g = (torch.randn(b, t, d, device="cuda", generator=gen) for _ in range(4))
    bias = _bias(kind, b, t, gen)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (fused_attention.long_forward_launches, fused_attention.long_backward_launches)
    out = fused_attention(*leaves, bias, 0, heads, 0.0)
    grads = torch.autograd.grad(out, leaves, g)
    assert (fused_attention.long_forward_launches, fused_attention.long_backward_launches) == (
        before[0] + 1, before[1] + 1)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    want = attention_plain(*plain, bias, 0, heads, 0.0)
    want_grads = torch.autograd.grad(want, plain, g)
    torch.testing.assert_close(out, want, atol=ATOL, rtol=RTOL)
    atol = _chip_smoke().bwd_atol(t, d // heads)  # dh=64's start holds every width above 32
    for got, w in zip(grads, want_grads):
        torch.testing.assert_close(got, w, atol=atol, rtol=RTOL)


def test_kernel_rejects_too_long_sequences(gen):
    """The one-head kernel refuses a head its shared memory cannot hold;
    `fused_attention` routes that shape to the long forward."""
    q = torch.randn(1, 2000, 64, device="cuda", generator=gen)
    bias = _bias("zeros", 1, 2000, gen)
    with pytest.raises(ValueError, match="shared memory"):
        attention_ops._launch_forward(q, q, q, bias, 0, 1, 0.0, False, "sweep")
    longs = fused_attention.long_forward_launches
    torch.testing.assert_close(fused_attention(q, q, q, bias, 0, 1, 0.0),
                               attention_plain(q, q, q, bias, 0, 1, 0.0), atol=ATOL, rtol=RTOL)
    assert fused_attention.long_forward_launches == longs + 1


def test_model_on_cuda_goes_through_the_kernel(gen):
    cfg = ModelConfig(emb_dim=32, hid_dim=8, seq_len=12, batch_size=8, is_itc=True,
                      is_dr=True, item_length=50, user_length=50, sasrec_heads=2)
    model = build_model(cfg)  # default device: cuda
    assert model.cfg.kernels == "cuda"
    plain = build_model(dataclasses.replace(cfg, kernels="torch"), device="cuda")
    plain.load_state_dict(model.state_dict())
    batch = {k: torch.randint(0, 100, (8, 12), device="cuda", generator=gen)
             for k in ("seq_d1", "seq_d2")}
    before = fused_attention.launches
    got = user_representations(model, batch)
    assert fused_attention.launches == before + 4  # 2 towers x 2 blocks
    want = user_representations(plain, batch)
    assert fused_attention.launches == before + 4
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# max-affinity kernels
# ---------------------------------------------------------------------------

AFF_ATOL, AFF_RTOL = 1e-4, 1e-5  # same bf16 inputs, fp32 sums in another order


@pytest.mark.parametrize("shape,d", [
    ((256, 256, 20, 20), 128), ((11, 13, 20, 20), 128), ((5, 7, 33, 9), 32),
    ((3, 4, 17, 24), 16), ((9, 5, 40, 48), 64), ((1, 1, 1, 1), 128),
    ((37, 300, 20, 9), 128), ((256, 256, 80, 20), 128), ((3, 5, 7, 64), 128),
    ((1, 1, 1, 150), 128),
    ((256, 256, 20, 20), 96), ((11, 13, 40, 40), 96), ((3, 5, 7, 9), 8),  # D not a power of 2
    ((5, 7, 33, 9), 20), ((3, 4, 17, 24), 44),  # D not a multiple of 8
    ((256, 256, 20, 20), 1024), ((11, 13, 40, 40), 136), ((37, 300, 10, 9), 300),  # planes
])
def test_affinity_kernels_match_plain_and_each_other(gen, shape, d):
    """Both kernels at shapes the small-N kernel takes: ragged batches (no
    padding rows), N != M, time axes that are no multiple of 8, 8, 4 and 2
    users a slot, peers that straddle bank tiles and slices (M=9 over 300
    peers), one user against one long peer, every compiled width. Both
    kernels issue the same eight wgmma k16 steps for every score, whatever
    the slot width, so they agree bit for bit."""
    b, c, n, m = shape
    a = torch.randn(b, n, d, device="cuda", generator=gen)
    bank = torch.randn(c, m, d, device="cuda", generator=gen)
    before = (max_affinity_blocked.launches, max_affinity_smalln.launches)
    k6, k7 = max_affinity_blocked(a, bank), max_affinity_smalln(a, bank)
    assert (max_affinity_blocked.launches, max_affinity_smalln.launches) == (
        before[0] + 1, before[1] + 1)
    want = max_affinity_plain(a, bank)
    torch.testing.assert_close(k6, want, atol=AFF_ATOL, rtol=AFF_RTOL)
    assert torch.equal(k6, k7)
    assert k6.dtype == torch.float32 and tuple(k6.shape) == (b, c)


@pytest.mark.parametrize("shape", [(64, 64, 150, 150), (11, 13, 150, 150), (4, 6, 300, 300),
                                   (7, 3, 150, 20), (256, 256, 150, 150), (3, 5, 450, 450),
                                   (2, 3, 640, 17), (256, 255, 150, 150), (3, 5, 700, 9),
                                   (2, 3, 1300, 17)])
@pytest.mark.parametrize("d", [128, 1024])
def test_blocked_affinity_kernel_takes_long_sequences(gen, shape, d):
    """Up to four query slots a user (N up to 640) in one block, beyond that
    KC / 4 blocks a user folding into its outputs, a peer count the slices
    do not divide (C=255 in two slices of 128 and 127), one plane and eight."""
    b, c, n, m = shape
    a = torch.randn(b, n, d, device="cuda", generator=gen)
    bank = torch.randn(c, m, d, device="cuda", generator=gen)
    torch.testing.assert_close(max_affinity_blocked(a, bank), max_affinity_plain(a, bank),
                               atol=AFF_ATOL, rtol=AFF_RTOL)


def test_affinity_all_negative_scores_survive_the_tile_padding(gen):
    """Padding rows repeat a real row; a zero row would win a maximum of
    negative scores."""
    a = torch.rand(3, 5, 32, device="cuda", generator=gen) + 0.5
    bank = -(torch.rand(4, 7, 32, device="cuda", generator=gen) + 0.5)
    want = max_affinity_plain(a, bank)
    assert (want < 0).all()
    for fn in (max_affinity_blocked, max_affinity_smalln):
        torch.testing.assert_close(fn(a, bank), want, atol=AFF_ATOL, rtol=AFF_RTOL)


def test_affinity_dispatch_and_refusals(gen):
    a20 = torch.randn(4, 20, 128, device="cuda", generator=gen)
    a150 = torch.randn(4, 150, 128, device="cuda", generator=gen)
    k6, k7 = max_affinity_blocked.launches, max_affinity_smalln.launches
    max_affinity(a20, a20, "cuda")  # the predicate: the small-N kernel at T=20
    assert (max_affinity_blocked.launches, max_affinity_smalln.launches) == (k6, k7 + 1)
    max_affinity(a150, a150, "cuda")  # and the blocked one at T=150
    assert (max_affinity_blocked.launches, max_affinity_smalln.launches) == (k6 + 1, k7 + 1)
    max_affinity(a150, a150, "torch")  # fp32, no kernel
    assert (max_affinity_blocked.launches, max_affinity_smalln.launches) == (k6 + 1, k7 + 1)
    a81 = torch.randn(2, 81, 128, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="N <= 80"):
        max_affinity_smalln(a81, a20)
    long = torch.randn(1, 641, 128, device="cuda", generator=gen)  # eight slots, two blocks
    torch.testing.assert_close(max_affinity_blocked(long, long), max_affinity_plain(long, long),
                               atol=AFF_ATOL, rtol=AFF_RTOL)
    odd = torch.randn(2, 4, 44, device="cuda", generator=gen)  # not a multiple of 8
    for fn in (max_affinity_blocked, max_affinity_smalln):
        torch.testing.assert_close(fn(odd, odd), max_affinity_plain(odd, odd),
                                   atol=AFF_ATOL, rtol=AFF_RTOL)
        with pytest.raises(ValueError, match="seq_b on cpu"):
            fn(a20, a20.cpu())
    assert (max_affinity_blocked.launches, max_affinity_smalln.launches) == (k6 + 3, k7 + 2)
    # the C side refuses a query longer than its limit, and a plan it has no
    # instance for, on its own
    out = torch.empty(2, 4, device="cuda")
    head = (a81.data_ptr(), a20.data_ptr(), 0, out.data_ptr(), 0, 2, 4, 81, 20, 128)
    assert affinity_ops._smalln(struct.pack("<15q", *head, 160, 2, 1, 4, 2)) == -3
    head = head[:7] + (20,) + head[8:]
    assert affinity_ops._smalln(struct.pack("<15q", *head, 160, 3, 1, 4, 2)) == -2  # U = 3
    assert affinity_ops._smalln(struct.pack("<15q", *head, 32, 2, 1, 4, 2)) == -2  # W < N U
    # the wrappers' shared-memory arithmetic is the kernels' own
    from amid_tpu_torch.ops.affinity import smem_bytes_of_the_kernels
    smem_bytes = smem_bytes_of_the_kernels()
    for n, m, d in ((150, 150, 128), (20, 20, 128), (33, 9, 32), (300, 300, 64), (80, 80, 128),
                    (1, 150, 16), (41, 7, 64), (150, 150, 1024), (20, 20, 1024), (700, 9, 136)):
        plans = [blocked_plan(256, 256, n, m, d)] + ([smalln_plan(256, 256, n, m, d)]
                                                     if n <= affinity_ops.smalln_max_n(d) else [])
        for plan in plans:
            assert smem_bytes(plan.width, plan.users, plan.stages, plan.peers,
                              plan.planes) == plan.smem == affinity_smem_bytes(
                plan.width, plan.stages, plan.peers, plan.users, plan.planes)


# ---------------------------------------------------------------------------
# scoring head
# ---------------------------------------------------------------------------

def _head(gen, b, c, d, h):
    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    fc1 = rand(h, 2 * d, scale=(2 * d) ** -0.5)
    return [rand(b, d), rand(b, c, d), fc1, rand(h, scale=0.1), rand(1, h, scale=h ** -0.5),
            rand(1, scale=0.1)]


@pytest.mark.parametrize("b,c,d,h", [(256, 1000, 128, 32), (256, 2, 128, 32), (7, 37, 64, 8),
                                     (5, 9, 32, 40), (3, 1, 128, 33), (2, 130, 256, 64),
                                     (5, 70, 1024, 64), (3, 33, 2048, 32), (4, 37, 1026, 32),
                                     (2, 65, 90, 12), (2, 9, 258, 300)])
def test_scoring_head_kernel_matches_plain(gen, b, c, d, h):
    """Candidate counts that are no multiple of the 4 a warp scores together,
    hidden widths below, at and above one warp, fc1 read through the row
    stride of its two halves; the wide kernel's shapes (Wi^T beyond a block,
    D not a multiple of 4, H above the user half's pass of 128 units)."""
    user, items, fc1, b1, w2, b2 = _head(gen, b, c, d, h)
    args = (user, items, fc1[:, :d], fc1[:, d:], b1, w2, b2)
    before = scoring_head.launches
    with torch.no_grad():
        got = scoring_head(*args)
        assert scoring_head.launches == before + 1
        torch.testing.assert_close(got, scoring_head_plain(*args), atol=1e-5, rtol=1e-5)
        strided = torch.randn(b, c, d + 4, device="cuda", generator=gen)[..., 4:]
        torch.testing.assert_close(scoring_head(user, strided, *args[2:]),
                                   scoring_head_plain(user, strided, *args[2:]),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,c,d,h", [(256, 1000, 128, 32), (256, 2, 128, 32), (256, 1, 128, 32),
                                     (7, 37, 64, 8), (3, 1, 128, 33), (2, 130, 256, 64)])
def test_scoring_head_pair_kernel_matches_plain(gen, b, c, d, h):
    """Both users in one launch against two calls of the plain version, with
    contiguous and with strided item views (a [B, C, D] slice of a wider
    tensor, and every other candidate)."""
    user, items, fc1, b1, w2, b2 = _head(gen, b, c, d, h)
    other = torch.randn(b, d, device="cuda", generator=gen)
    params = (fc1[:, :d], fc1[:, d:], b1, w2, b2)
    wide = torch.randn(b, 2 * c, d + 4, device="cuda", generator=gen)
    before = scoring_head.launches
    with torch.no_grad():
        for cand in (items, wide[:, :c, 4:], wide[:, ::2, :d]):
            got = scoring_head_pair(user, other, cand, *params)
            for g, u in zip(got, (user, other)):
                assert g.dtype == torch.float32 and tuple(g.shape) == (b, c)
                torch.testing.assert_close(g, scoring_head_plain(u, cand, *params),
                                           atol=1e-5, rtol=0)
            assert torch.equal(got[0], scoring_head(user, cand, *params))
    assert scoring_head.launches == before + 6


def test_scoring_head_pair_gradients_match_autograd_through_the_plain_pair(gen):
    d = 128
    leaves = [x.requires_grad_() for x in _head(gen, 16, 5, d, 32)]
    leaves.append(torch.randn(16, d, device="cuda", generator=gen).requires_grad_())

    def grads(fn):
        user, items, fc1, b1, w2, b2, other = leaves
        o1, o2 = fn(user, other, items, fc1[:, :d], fc1[:, d:], b1, w2, b2)
        return torch.autograd.grad((o1 ** 2).sum() + o2.sum(), leaves)

    before = scoring_head.launches
    got = grads(scoring_head_pair)
    assert scoring_head.launches == before + 1  # one launch; the backward is plain
    for g, w in zip(got, grads(scoring_head_pair_plain)):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)


def test_scoring_plan_is_the_kernels_shared_memory(gen):
    smem, smem_up = scoring_ops.smem_bytes_of_the_kernels()
    lib = scoring_ops._build.load("scoring_head")
    which = scoring_ops._build.bind(lib.scoring_head_main_kernel, [ctypes.c_int] * 2)
    cols = scoring_ops._build.bind(lib.scoring_head_tile_cols, [ctypes.c_int] * 2)
    for b, c, d, h in ((256, 1000, 128, 32), (256, 2, 128, 33), (2, 130, 256, 64),
                       (256, 1000, 1024, 32), (256, 1000, 1024, 64), (4, 5, 2048, 32),
                       (4, 5, 1026, 32), (3, 7, 30, 4), (2, 3, 4096, 256)):
        assert smem(d, h) == scoring_ops.scoring_plan(b, c, d, h).smem
        assert smem_up(d, h) == scoring_ops.user_half_smem_bytes(d, h)
        assert ("whole", "chunked", "wide")[which(d, h)] == scoring_ops.scoring_kernel(d, h)
        assert cols(d, h) == scoring_ops.tile_cols(d, h)


def test_scoring_head_gradients_reach_fc1_as_one_parameter(gen):
    d = 128
    leaves = [x.requires_grad_() for x in _head(gen, 16, 5, d, 32)]

    def grads(fn):
        user, items, fc1, b1, w2, b2 = leaves
        out = fn(user, items, fc1[:, :d], fc1[:, d:], b1, w2, b2)
        return torch.autograd.grad((out ** 2).sum(), leaves)

    before = scoring_head.launches
    got = grads(scoring_head)
    assert scoring_head.launches == before + 1  # the backward is plain PyTorch
    for g, w in zip(got, grads(scoring_head_plain)):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)
    assert tuple(got[2].shape) == (32, 2 * d)


def test_scoring_head_refusals(gen):
    """A tensor on another device is refused; D not a multiple of 4 and a D
    whose Wi^T does not fit a block run on the wide kernel, as the plain
    version computes them."""
    for b, c, d, h in ((2, 3, 30, 4), (1, 1, 1024, 64), (3, 70, 1030, 40)):
        user, items, fc1, b1, w2, b2 = _head(gen, b, c, d, h)
        args = (user, items, fc1[:, :d], fc1[:, d:], b1, w2, b2)
        assert scoring_ops.scoring_kernel(d, h) == "wide"
        torch.testing.assert_close(scoring_head(*args), scoring_head_plain(*args), atol=1e-5,
                                   rtol=1e-5)
    user, items, fc1, b1, w2, b2 = _head(gen, 2, 3, 32, 4)
    with pytest.raises(ValueError, match="b1 on cpu"):
        scoring_head(user, items, fc1[:, :32], fc1[:, 32:], b1.cpu(), w2, b2)


# ---------------------------------------------------------------------------
# embedding gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,d,shape,id_dtype", [
    (50_000, 128, (256, 999), torch.int32), (50_000, 128, (256,), torch.int64),
    (100, 7, (3, 5), torch.int64), (64, 20, (0,), torch.int32),
])
def test_gather_kernel_matches_plain_bit_for_bit(gen, v, d, shape, id_dtype):
    table = torch.randn(v, d, device="cuda", generator=gen)
    ids = torch.randint(0, v, shape, device="cuda", generator=gen).to(id_dtype)
    before = embedding_gather.launches
    got = embedding_gather(table, ids)
    assert embedding_gather.launches == before + 1
    assert torch.equal(got, embedding_gather_plain(table, ids))
    assert tuple(got.shape) == (*shape, d)


def test_gather_kernel_clamps_and_reads_row_views(gen):
    table = torch.randn(40, 16, device="cuda", generator=gen)
    wild = torch.tensor([-5, 0, 39, 40, 10**9], device="cuda")
    want = table[torch.tensor([0, 0, 39, 39, 39], device="cuda")]
    assert torch.equal(embedding_gather(table, wild), want)
    wide = torch.randn(40, 24, device="cuda", generator=gen)
    view = wide[:, 3:19]  # row stride 24, unaligned start: the scalar path
    ids = torch.randint(0, 40, (9,), device="cuda", generator=gen)
    assert torch.equal(embedding_gather(view, ids), view[ids])
    with pytest.raises(ValueError, match="unit stride"):
        embedding_gather(wide.T, ids)
    with pytest.raises(ValueError, match="ids on cpu"):
        embedding_gather(table, ids.cpu())


def test_gather_gradient_adds_duplicated_ids(gen):
    table = torch.randn(50, 128, device="cuda", generator=gen, requires_grad=True)
    ids = torch.randint(0, 50, (64, 9), device="cuda", generator=gen)
    upstream = torch.randn(64, 9, 128, device="cuda", generator=gen)
    (got,) = torch.autograd.grad(embedding_gather(table, ids), table, upstream)
    (want,) = torch.autograd.grad(embedding_gather_plain(table, ids), table, upstream)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _runs(kind, gen):
    """Ids whose runs meet the backward's work units in every way: one key
    over many tiles of 128 positions, runs of 256, 255, 511 positions and
    one, left-padded histories (row 0 in every tile), a single position, a
    last tile of one position."""
    cuda = dict(device="cuda")
    if kind == "one_key":
        return torch.full((1000,), 7, **cuda)
    if kind == "edges":
        return torch.repeat_interleave(torch.arange(6, **cuda),
                                       torch.tensor([256, 255, 2, 256, 511, 1], **cuda))
    if kind == "padded":
        ids = torch.randint(1, 2_000, (256, 300), **cuda, generator=gen)
        lens = torch.randint(1, 301, (256, 1), **cuda, generator=gen)
        return torch.where(torch.arange(300, **cuda)[None] < 300 - lens, 0, ids).reshape(-1)
    if kind == "single":
        return torch.tensor([5], **cuda)
    return torch.randint(0, 2_000, (257,), **cuda, generator=gen)  # "ragged"


@pytest.mark.parametrize("kind", ["one_key", "edges", "padded", "single", "ragged"])
@pytest.mark.parametrize("width", [128, 7])
def test_gather_grad_kernel_matches_plain_and_repeats_bit_for_bit(gen, kind, width):
    """`embedding_gather_grad` against the plain version in fp64, no further
    from it than the plain fp32 version (`index_add_`) give or take 1e-5
    (the padding row sums about 38k terms near 1: either fp32 order parts
    from fp64 by up to about 1e-3), and against itself: two calls on the
    same inputs are bit-equal; each call counts one launch."""
    ids = _runs(kind, gen)
    ids = ids[torch.randperm(ids.numel(), device="cuda", generator=gen)]
    g = torch.randn(ids.numel(), width, device="cuda", generator=gen)
    before = embedding_gather_grad.launches
    first, second = (embedding_gather_grad(ids, g, 2_000) for _ in range(2))
    assert embedding_gather_grad.launches == before + 2
    exact = embedding_gather_grad_plain(ids, g.double(), 2_000)
    plain_err = (embedding_gather_grad_plain(ids, g, 2_000) - exact).abs().max().item()
    assert (first - exact).abs().max().item() <= plain_err + 1e-5
    assert torch.equal(first, second)


def test_gather_grad_kernel_in_a_cuda_graph_equals_the_eager_call(gen):
    """Sort, scratch and both kernels replay from a graph, bit-equal to the
    eager call, and a replay reads the gradient's new values."""
    ids = _runs("padded", gen)
    g = torch.randn(ids.numel(), 128, device="cuda", generator=gen)
    embedding_gather_grad(ids, g, 2_000)  # binds the kernels outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = embedding_gather_grad(ids, g, 2_000)
    g.copy_(torch.randn(ids.numel(), 128, device="cuda", generator=gen))
    graph.replay()
    assert torch.equal(got, embedding_gather_grad(ids, g, 2_000))

def _lazy_positions(gen):
    """A lazy T=20 step's two backward id arrays: both sequences (10,240
    left-padded positions) and target with a negative (512), as positions
    among the step's unique rows (11,264 at most)."""
    v, b = 894_820, 256

    def padded(t):
        ids = torch.randint(1, v, (b, t), device="cuda", generator=gen)
        lens = torch.randint(1, t + 1, (b, 1), device="cuda", generator=gen)
        return torch.where(torch.arange(t, device="cuda")[None] < t - lens, 0, ids)

    seqs = torch.cat([padded(20), padded(20)], 1).reshape(-1)
    cand = torch.randint(0, v, (2 * b,), device="cuda", generator=gen)
    _, pos = torch.unique(torch.cat([cand, seqs]), return_inverse=True)
    return pos[cand.numel():].int(), pos[:cand.numel()].int(), padded


@pytest.mark.parametrize("case", ["lazy_pair20", "lazy_cand2", "pair150"])
def test_gather_grad_kernel_at_the_training_step_s_shapes(gen, case):
    """The lazy step's two shapes (into its 11,264-row leaf: two launches at
    10,240 positions, one at 512) and a T=150 step's two sequences into the
    894,820-row table: bit-equal to `embedding_gather_grad_ordered` (the
    kernel's order in plain PyTorch), as close to the fp64 sums as
    `index_add_` give or take 1e-5, bit-equal over two calls and when
    replayed from a CUDA graph with new gradients."""
    pair20, cand2, padded = _lazy_positions(gen)
    ids, rows = {"lazy_pair20": (pair20, 11_264), "lazy_cand2": (cand2, 11_264),
                 "pair150": (torch.cat([padded(150), padded(150)], 1).reshape(-1).int(),
                             894_820)}[case]
    g = torch.randn(ids.numel(), 128, device="cuda", generator=gen)
    first, second = (embedding_gather_grad(ids, g, rows) for _ in range(2))
    assert torch.equal(first, second)
    assert torch.equal(first, embedding_gather_grad_ordered(ids, g, rows))
    exact = embedding_gather_grad_plain(ids, g.double(), rows)
    plain_err = (embedding_gather_grad_plain(ids, g, rows) - exact).abs().max().item()
    assert (first - exact).abs().max().item() <= plain_err + 1e-5
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = embedding_gather_grad(ids, g, rows)
    g.copy_(torch.randn(ids.numel(), 128, device="cuda", generator=gen))
    graph.replay()
    assert torch.equal(got, embedding_gather_grad_ordered(ids, g, rows))


@pytest.mark.parametrize("concat", [False, True])
def test_gather_many_gradient_is_the_ordered_sum_of_its_lookups(gen, concat):
    """A group of two lookups hands each lookup's ids and gradient to one
    backward launch (no concatenation): the table's gradient is
    `embedding_gather_grad_ordered` of the ids and gradients one lookup
    after the other (side by side per user with concat=True), bit for bit."""
    table = torch.randn(3_000, 128, device="cuda", generator=gen, requires_grad=True)
    ids = [torch.randint(0, 3_000, (256, 20), device="cuda", generator=gen),
           torch.randint(0, 3_000, (256, 30), device="cuda", generator=gen)]
    out = embedding_gather_many(table, ids, concat=concat)
    outs = (out,) if concat else out
    grads = [torch.randn_like(o) for o in outs]
    before = embedding_gather_grad.launches
    got = torch.autograd.grad(outs, table, grads)[0]
    assert embedding_gather_grad.launches == before + 1
    if concat:
        flat = torch.cat(ids, dim=1).reshape(-1)
        g = grads[0].reshape(-1, 128)
    else:
        flat = torch.cat([i.reshape(-1) for i in ids])
        g = torch.cat([x.reshape(-1, 128) for x in grads])
    assert torch.equal(got, embedding_gather_grad_ordered(flat, g, 3_000))


@pytest.mark.parametrize("n_segments", [1, 2, 3, 4])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_gather_many_matches_plain_bit_for_bit(gen, n_segments, id_dtype):
    """1 to 4 lookups in one launch: id arrays of different ranks and lengths
    per user (1, 37, 2 x 5, 999 ids), ragged against the 8 rows a warp takes."""
    v, d, b = 50_000, 128, 48
    table = torch.randn(v, d, device="cuda", generator=gen)
    shapes = [(b,), (b, 37), (b, 2, 5), (b, 999)][:n_segments]
    ids = [torch.randint(0, v, s, device="cuda", generator=gen).to(id_dtype) for s in shapes]
    before = embedding_gather.launches
    got = embedding_gather_many(table, ids)
    assert embedding_gather.launches == before + 1
    for g, w, s in zip(got, embedding_gather_many_plain(table, ids), shapes):
        assert tuple(g.shape) == (*s, d) and torch.equal(g, w)
    side = embedding_gather_many(table, ids, concat=True)
    assert embedding_gather.launches == before + 2
    assert side.is_contiguous()
    assert torch.equal(side, embedding_gather_many_plain(table, ids, concat=True))
    assert torch.equal(side[:, 0], got[0])


def test_gather_many_writes_strided_destinations(gen):
    """`concat=True`: each lookup's destination is a view of the [B, P, D]
    block with the block's stride between users, also when a lookup brings no
    id per user. A narrow table and mixed id types take the float route and
    the int64 conversion."""
    v, d, b = 1_000, 128, 16
    table = torch.randn(v, d, device="cuda", generator=gen)
    ids = [torch.randint(0, v, (b,), device="cuda", generator=gen),
           torch.randint(0, v, (b, 6), device="cuda", generator=gen).to(torch.int32),
           torch.randint(0, v, (b, 0), device="cuda", generator=gen),
           torch.randint(0, v, (b, 3), device="cuda", generator=gen)]
    block = embedding_gather_many(table, ids, concat=True)
    assert tuple(block.shape) == (b, 10, d)
    assert torch.equal(block[:, 0], table[ids[0]])
    assert torch.equal(block[:, 1:7], table[ids[1].long()])
    assert torch.equal(block[:, 7:], table[ids[3]])
    narrow = torch.randn(100, 7, device="cuda", generator=gen)
    small = [i % 100 for i in ids]
    for concat in (False, True):
        got = embedding_gather_many(narrow, small, concat=concat)
        want = embedding_gather_many_plain(narrow, small, concat=concat)
        for g, w in zip([got] if concat else got, [want] if concat else want):
            assert torch.equal(g, w)
    scalar = torch.tensor(5, device="cuda")  # a lookup without a user axis
    assert torch.equal(embedding_gather(table, scalar), table[5])


@pytest.mark.parametrize("concat", [False, True])
def test_gather_many_gradient_adds_up_across_lookups(gen, concat):
    table = torch.randn(50, 128, device="cuda", generator=gen, requires_grad=True)
    ids = [torch.randint(0, 50, (64,), device="cuda", generator=gen),
           torch.randint(0, 50, (64, 9), device="cuda", generator=gen)]

    def grad(fn):
        out = fn(table, ids, concat=concat)
        loss = (out ** 2).sum() if concat else sum((o ** 2).sum() for o in out)
        return torch.autograd.grad(loss, table)[0]

    before = embedding_gather.launches
    got = grad(embedding_gather_many)
    assert embedding_gather.launches == before + 1
    torch.testing.assert_close(got, grad(embedding_gather_many_plain), atol=1e-5, rtol=1e-5)
    with torch.no_grad():  # no Function without a gradient: a plain tensor comes back
        out = embedding_gather_many(table, ids, concat=concat)
    assert not (out if concat else out[0]).requires_grad


def test_gather_refusals_of_the_c_entry_point(gen):
    """Each code of `csrc/gather_rows.cu` comes back as its exception."""
    table = torch.randn(40, 16, device="cuda", generator=gen)
    ids = torch.randint(0, 40, (4, 3), device="cuda", generator=gen)
    before = embedding_gather.launches
    with pytest.raises(ValueError, match="V >= 1"):
        embedding_gather(torch.zeros(0, 16, device="cuda"), ids)
    with pytest.raises(ValueError, match="unit stride"):  # -2
        embedding_gather_many(torch.randn(16, 40, device="cuda", generator=gen).T, [ids, ids])
    with pytest.raises(ValueError, match="1 to 4 id arrays"):
        embedding_gather_many(table, [ids] * 5)
    with pytest.raises(ValueError, match="share their first axis"):
        embedding_gather_many(table, [ids, ids[:2]], concat=True)
    assert embedding_gather.launches == before
    embedding_gather_many(table, [ids])  # binds the entry point
    fn = embedding_ops._gather_rows
    # table, its strides, V, width | ids64, segments, device, stream | segments
    head = (table.data_ptr(), 16, 1, 40, 16)
    assert fn(struct.pack("14q", table.data_ptr(), 16, 1, 0, 16, 1, 1, 0, 0,
                          0, 4, 4, 0, 0)) == -1  # V = 0
    assert fn(struct.pack("9q", *head, 1, 5, 0, 0)) == -3  # 5 segments
    assert fn(struct.pack("14q", *head, 1, 1, 0, 0, 0, 7, 2, 0, 0)) == -3  # 7 ids, 2 per user
    assert fn(struct.pack("14q", *head, 1, 1, 0, 0, 0, 2 ** 31, 1, 0, 0)) == -4
    assert set(embedding_ops._REFUSALS) == {-1, -2, -3, -4, -5}
    # the backward's entry: segments, V, width, ids64, out, scratch, its bytes,
    # device, stream | ids, n, gradient, its row stride
    grad_fn = embedding_ops._gather_rows_grad
    g = torch.randn(2_000, 16, device="cuda", generator=gen)
    many = torch.randint(0, 40, (2_000,), device="cuda", generator=gen)
    dtable = torch.empty(40, 16, device="cuda")
    seg = (many.data_ptr(), 2_000, g.data_ptr(), 16)
    assert grad_fn(struct.pack("13q", 1, 0, 16, 1, dtable.data_ptr(), 0, 0, 0, 0, *seg)) == -1
    assert grad_fn(struct.pack("9q", 5, 40, 16, 1, dtable.data_ptr(), 0, 0, 0, 0)) == -3
    assert grad_fn(struct.pack("13q", 1, 40, 16, 1, dtable.data_ptr(), 0, 0, 0, 0,
                               many.data_ptr(), -1, g.data_ptr(), 16)) == -3
    # 2,000 rows take the two passes, whose scratch the call must bring
    assert grad_fn(struct.pack("13q", 1, 40, 16, 1, dtable.data_ptr(), 0, 0, 0, 0, *seg)) == -5
    with pytest.raises(RuntimeError, match="scratch"):
        embedding_ops._raise(-5, "gather_rows_grad")
    # a card that is not there: the query's cudaError comes back, nothing is guessed
    out = torch.empty(4, 3, 16, device="cuda")
    assert fn(struct.pack("14q", *head, 1, 1, 99, 0, ids.data_ptr(), 12, 12,
                          out.data_ptr(), 0)) > 0


# ---------------------------------------------------------------------------
# the pairwise model on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq_len,kernel", [(12, max_affinity_smalln), (96, max_affinity_blocked)])
def test_pairwise_step_on_cuda_goes_through_all_kernels(gen, seq_len, kernel):
    """The dispatch sends queries up to 80 long to the small-N kernel."""
    cfg = ModelConfig(emb_dim=32, hid_dim=8, seq_len=seq_len, batch_size=8, is_itc=True,
                      ts2=0.1, is_dr=True, item_length=50, user_length=50, sasrec_heads=2,
                      comp_broadcast_quirk=False)
    model = build_model(cfg)
    v = cfg.item_table_size
    batch = {"target": torch.randint(0, v, (8,), device="cuda", generator=gen),
             "seq_d1": torch.randint(0, v, (8, seq_len), device="cuda", generator=gen),
             "seq_d2": torch.randint(0, v, (8, seq_len), device="cuda", generator=gen),
             "domain_id": torch.randint(0, 2, (8,), device="cuda", generator=gen),
             "reject": torch.full((8, 1), v, device="cuda"),
             "reject_counts": torch.zeros(8, dtype=torch.long, device="cuda"),
             "ob_label": torch.ones(8, dtype=torch.long, device="cuda")}
    pools = torch.arange(v, device="cuda").repeat(2, 1)
    sizes = torch.tensor([v, v], device="cuda")
    state = lazy.init_lazy_state(dict(model.named_parameters()), Adam(1e-3))
    step = lazy.make_lazy_train_step(model, Adam(1e-3), dr_e_w=0.1)
    counters = (embedding_gather, scoring_head, kernel)
    before = [f.launches for f in counters]
    _, m = step(state, batch, pools, sizes, 5)
    assert [f.launches - b for f, b in zip(counters, before)] == [2, 3, 2]
    assert torch.isfinite(m["loss"]) and abs(float(m["loss_cls"]) - 0.693) < 0.05
    # the same weights with plain everything and the kernels' bf16 affinity
    plain = build_model(dataclasses.replace(cfg, kernels="torch"), device="cuda")
    plain.load_state_dict(model.state_dict())
    for name in ("itc_d1", "itc_d2"):
        getattr(plain, name).message.affinity = max_affinity_plain
    feats = {k: batch[k] for k in ("seq_d1", "seq_d2")}
    for g, w in zip(user_representations(model, feats), user_representations(plain, feats)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the fast loops: steps captured as CUDA graphs and replayed
# ---------------------------------------------------------------------------

LOSS_TOL = 1e-5  # a replayed step against the eager step (chip_smoke.py's phase 4)
MOMENT_TOL = 2e-4  # max |difference| of a moment array over its max |value|
FAST_BS, FAST_T = 64, 20


def _rel_to_max(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def _fast_cfg(**kw):
    return ModelConfig(emb_dim=64, hid_dim=16, seq_len=FAST_T, batch_size=FAST_BS,
                       is_itc=True, ts2=0.4, is_dr=True, item_length=3000,
                       user_length=3000, sasrec_heads=4, **kw)


def _fast_pair(kind, phase, cfg):
    """Two models from one seed with their states and steps of one kind:
    the first steps eagerly, the second through a runner's graph."""
    made = []
    for _ in range(2):
        model = build_model(cfg, seed=0)
        tx, tx2 = Adam(1e-3), Adam(2e-3)
        if kind == "lazy":
            state = lazy.init_lazy_state(dict(model.named_parameters()), tx, tx2)
            step = (lazy.make_lazy_train_step(model, tx, dr_e_w=0.1) if phase == "A"
                    else lazy.make_lazy_dr_r_step(model, tx2))
        else:
            state = steps.init_state(model, tx, tx2)
            step = (steps.make_train_step(model, tx, dr_e_w=0.1) if phase == "A"
                    else steps.make_dr_r_step(model, tx2))
        made.append((model, state, step))
    return made


def _moments(state, phase, kind):
    opt = state.opt_state if phase == "A" else state.opt_state2
    if kind == "lazy":
        return {"table_mu": opt.mu, "table_nu": opt.nu, "dense": opt.dense_opt.mu,
                "count": opt.count}
    return {"table_mu": opt.mu["item_embedding"], "table_nu": opt.nu["item_embedding"],
            "dense": {k: v for k, v in opt.mu.items() if k != "item_embedding"},
            "count": opt.count}


@pytest.mark.parametrize("pairwise", [False, True], ids=["quirk", "pairwise"])
@pytest.mark.parametrize("phase", ["A", "B"])
@pytest.mark.parametrize("kind", ["lazy", "dense"])
def test_replayed_train_steps_equal_eager_steps(gen, kind, phase, pairwise):
    """Four steps through a resident chunk runner (the first eager, the
    second captured and replayed, then two replays) against the same four
    steps taken eagerly from the same state, batches and keys. Dropout 0.5
    and the sampler on: a replay draws what the eager step draws. The two
    agree within rounding, not bit for bit: the gather's backward and
    torch's scatters add with atomics in no fixed order. A replay that read
    a number frozen at capture (the step count, a seed, the batch index)
    would leave the eager trajectory at its second step."""
    cfg = _fast_cfg(comp_broadcast_quirk=not pairwise)
    ds = synth_packed(cfg, np.random.default_rng(0), 4 * FAST_BS)
    (_, est, estep), (_, gst, gstep) = _fast_pair(kind, phase, cfg)
    arrays = loop._resident(ds.batch_arrays(), "cuda")
    pools = loop._device_pools(ds, "cuda")
    perm = torch.as_tensor(np.random.default_rng(1).permutation(4 * FAST_BS).astype(np.int32),
                           device="cuda")
    pool = GraphPool("cuda")
    try:
        runner = steps.make_resident_chunk_runner(gstep, FAST_BS, pool)
        before = launches.read()
        for i in range(4):
            _, m0, nf = runner(gst, arrays, perm, *pools, 9, range(i, i + 1), range(i, i + 1))
            rows = perm[i * FAST_BS:(i + 1) * FAST_BS]
            batch = {k: v.index_select(0, rows) for k, v in arrays.items()}
            _, m = estep(est, batch, *pools, fold_in(9, i))
            assert float(nf) == 0.0
            for k, v in m0.items():
                assert abs(float(v) - float(m[k])) <= LOSS_TOL, (i, k, float(v), float(m[k]))
        graph = pool.graphs[0]
        assert graph.replays == 3 and graph.graph is not None
        # the counts are launches on the device: the runner's eager step and 3
        # replays, and the eager model's 4 steps
        per_step = graph.captured
        assert per_step["attention_fwd"] == per_step["attention_bwd"] == 4
        assert per_step["scatter_set_unique3"] == int(kind == "lazy")
        assert launches.since(before) == {k: 8 * n for k, n in per_step.items()}
        got, want = _moments(gst, phase, kind), _moments(est, phase, kind)
        assert int(got["count"]) == int(want["count"]) == 4
        for k in ("table_mu", "table_nu"):
            assert _rel_to_max(got[k], want[k]) <= MOMENT_TOL, k
        for k, v in got["dense"].items():
            assert _rel_to_max(v, want["dense"][k]) <= MOMENT_TOL, k
    finally:
        pool.close()


def test_replayed_evaluation_equals_the_eager_batches(gen):
    """Two stacked evaluation passes (the first batch eager, the second
    captured, then replays) against the per-batch eval step: each batch's
    loss within 1e-5 and its ranks equal, for two keys (negatives drawn by a
    replay are the eager step's)."""
    cfg = _fast_cfg()
    ds = synth_packed(cfg, np.random.default_rng(2), 4 * FAST_BS)
    model = build_model(cfg, seed=0)
    pools = loop._device_pools(ds, "cuda")
    idx = np.arange(4 * FAST_BS).reshape(4, FAST_BS)
    stacked = {k: torch.as_tensor(v[idx], device="cuda") for k, v in ds.batch_arrays().items()
               if k in loop.STEP_KEYS}
    pool = GraphPool("cuda")
    try:
        eval_all = steps.make_scanned_eval(model, 99, pool)
        eval_step = steps.make_eval_step(model, 99)
        for key in (10_000, 30_000):
            got = {k: v.clone() for k, v in eval_all(stacked, *pools, key).items()}
            for i in range(4):
                batch = {k: v[i] for k, v in stacked.items()}
                want = eval_step(batch, *pools, fold_in(key, i))
                assert abs(float(got["loss_cls"][i]) - float(want["loss_cls"])) <= LOSS_TOL
                for k in ("ranks_fixed", "ranks_raw"):
                    assert torch.equal(got[k][i], want[k]), (key, i, k)
        assert pool.graphs[0].replays == 7
    finally:
        pool.close()


def test_a_replay_draws_what_the_eager_step_draws_with_its_key(gen):
    """The step's generators registered with the graph: reseeding between
    replays changes the draws (negatives, a dropout mask, a K1 seed), and a
    replay after reseed(k) draws bit for bit what a fresh StepRandom(k) draws
    eagerly."""
    v, bsz = 1000, 64
    pools = torch.arange(v, device="cuda", dtype=torch.int32).repeat(2, 1)
    sizes = torch.tensor([v, v], device="cuda", dtype=torch.int32)
    dom = torch.randint(0, 2, (bsz,), device="cuda", generator=gen)
    reject = torch.sort(torch.randint(0, v, (bsz, 3), device="cuda", generator=gen)).values
    counts = torch.full((bsz,), 3, device="cuda")

    def draws(rng):
        neg = sample_negatives(rng.sampler, pools, sizes, dom, reject, 9, counts)
        mask = rng.dropout(torch.ones(bsz, 32, device="cuda"), 0.5)
        return neg, mask, rng.attention_seed()

    rng = StepRandom(None, "cuda")
    pool = GraphPool("cuda")
    try:
        graph = StepGraph(lambda: draws(rng), rng.generators(), pool)
        got = {}
        for key in (1, 2, 1, 3):  # eager, capture + replay, replay, replay
            rng.reseed(key)
            out = [x.clone() for x in graph()]
            assert key not in got or all(torch.equal(a, b) for a, b in zip(out, got[key]))
            got[key] = out
        assert graph.replays == 3
        for key, out in got.items():
            want = draws(StepRandom(key, "cuda"))
            assert all(torch.equal(a, b) for a, b in zip(out, want)), key
        for a, b in zip(got[2], got[3]):
            assert not torch.equal(a, b)
    finally:
        pool.close()


def test_no_launch_of_a_replay_reads_a_frozen_host_number(gen):
    """Each number a step takes from outside its inputs is read on the
    device at the replay: K1's dropout seed (a tensor refilled between
    replays), Adam's step count and bias corrections (five replays equal
    five eager updates), the lazy step's unique ids (new ids, new uniques)."""
    q, k, v = (torch.randn(8, 20, 64, device="cuda", generator=gen) for _ in range(3))
    bias = _bias("causal", 8, 20, gen)
    seed = torch.zeros(1, dtype=torch.int64, device="cuda")
    p = {"w": torch.randn(300, 7, device="cuda", generator=gen)}
    g = {"w": torch.randn(300, 7, device="cuda", generator=gen)}
    ids = torch.randint(0, 50, (200,), device="cuda", generator=gen, dtype=torch.int32)
    p_eager = {"w": p["w"].clone()}
    tx = Adam(1e-2)
    st, st_eager = tx.init(p), tx.init(p_eager)

    def body():
        tx.update_(p, g, st)
        return (fused_attention(q, k, v, bias, seed, 4, 0.5),
                lazy.unique_padded(ids, 256, 50))

    pool = GraphPool("cuda")
    try:
        graph = StepGraph(body, (), pool)
        for i in range(5):
            seed.fill_(1000 + i)
            ids.random_(0, 50, generator=gen)
            out, uniq = graph()
            tx.update_(p_eager, g, st_eager)
            torch.testing.assert_close(out, attention_plain(q, k, v, bias, 1000 + i, 4, 0.5),
                                       atol=ATOL, rtol=RTOL)
            want = torch.unique(ids)
            assert torch.equal(uniq[:want.numel()], want)
            assert bool((uniq[want.numel():] == 50).all())
        assert graph.replays == 4 and int(st.count) == 5
        torch.testing.assert_close(p["w"], p_eager["w"], atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(st.nu["w"], st_eager.nu["w"], atol=1e-7, rtol=1e-5)
    finally:
        pool.close()


@pytest.mark.parametrize("t", [20, 150])
def test_kernel_with_a_tensor_seed_equals_plain_with_dropout(gen, t):
    """K1 forward and backward with the seed a training step draws (a
    one-element int64 tensor on the card) against the plain version with
    the same tensor, and against the kernel with the seed as an int."""
    q, k, v = (torch.randn(16, t, 128, device="cuda", generator=gen).requires_grad_()
               for _ in range(3))
    bias = _bias("causal", 16, t, gen)
    seed = torch.tensor([987654], dtype=torch.int64, device="cuda")
    dout = torch.randn(16, t, 128, device="cuda", generator=gen)
    got = fused_attention(q, k, v, bias, seed, 8, 0.5)
    grads = torch.autograd.grad(got, (q, k, v), dout)
    want = attention_plain(q, k, v, bias, seed, 8, 0.5)
    want_grads = torch.autograd.grad(want, (q, k, v), dout)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    for a, b in zip(grads, want_grads):
        torch.testing.assert_close(a, b, atol=BWD_ATOL, rtol=RTOL)
    with torch.no_grad():
        assert torch.equal(fused_attention(q, k, v, bias, seed, 8, 0.5),
                           fused_attention(q, k, v, bias, 987654, 8, 0.5))


@pytest.mark.parametrize("lazy_adam", [True, False], ids=["lazy", "dense"])
def test_run_seed_runs_the_fast_loops_as_graphs(tmp_path, gen, lazy_adam):
    """`run_seed` on the card with the fast loops (the defaults): two epochs
    of the DR schedule, each step kind captured once and replayed, the
    counts launches on the device; the graphs are released at the end."""
    cfg = _fast_cfg()
    train, val, dr = (synth_packed(cfg, np.random.default_rng(i), n)
                      for i, n in ((3, 5 * FAST_BS), (4, 2 * FAST_BS), (5, 3 * FAST_BS)))
    tcfg = TrainConfig(epochs=2, seeds=1, checkpoint=False, model_dir=str(tmp_path),
                       lazy_table_adam=lazy_adam, model=cfg, data=DataConfig(neg_nums=99),
                       nan_policy="halt", log_every=2)
    assert tcfg.fast_train and tcfg.fast_eval
    captures = []
    capture = StepGraph._capture

    def counted(self):
        captures.append(self)
        capture(self)

    before = launches.read()
    try:
        StepGraph._capture = counted
        best = loop.run_seed(tcfg, 0, train, val, dr)
    finally:
        StepGraph._capture = capture
    torch.cuda.synchronize()
    got = launches.since(before)
    assert len(captures) == 3 and all(c.graph is None for c in captures)  # released
    # 2 epochs: 5 phase-A steps, 3 phase-B steps, 2 evaluations of 2 batches
    steps_, evals = 2 * (5 + 3), 2 * 2 * 2
    assert got["attention_fwd"] == 4 * (steps_ + evals)
    assert got["attention_bwd"] == 4 * steps_
    assert got["scatter_set_unique3"] == (steps_ if lazy_adam else 0)
    assert got["embedding_gather"] == 2 * (steps_ + evals)
    assert got["embedding_gather_grad"] == 2 * steps_
    assert got["scoring_head"] == 3 * (steps_ + evals)
    assert 0.0 <= best["mrr_d1"] <= 1.0 and np.isfinite(best["mrr_d2"])
    log = (tmp_path / "log0.txt").read_text()
    assert log.count("train loss:") == 2 * 3 and log.count("(post-DR)") == 2


@pytest.mark.parametrize("kind,pairwise", [("lazy", False), ("dense", True)],
                         ids=["lazy_quirk", "dense_pairwise"])
def test_restore_into_captured_graphs_replays_bit_for_bit(tmp_path, gen, kind, pairwise):
    """`chip_smoke.py`'s checkpoint phase, step 3, at a small size: two
    phase-A steps through a runner (eager, then captured and replayed), an
    async full save, three replays (state S1); restore, the same three keys
    (state S2): S1 == S2 bit for bit, every leaf. The restore wrote into the
    tensors the graph reads; one that rebound a tensor would leave the
    replays on S1's continuation. A params_only checkpoint then restores the
    parameters and zero moments and counts."""
    cfg = _fast_cfg(comp_broadcast_quirk=not pairwise)
    n = 3
    ds = synth_packed(cfg, np.random.default_rng(0), (2 + n) * FAST_BS)
    _, state, step = _fast_pair(kind, "A", cfg)[0]
    arrays = loop._resident(ds.batch_arrays(), "cuda")
    pools = loop._device_pools(ds, "cuda")
    perm = torch.arange((2 + n) * FAST_BS, dtype=torch.int32, device="cuda")
    pool = GraphPool("cuda")
    full = CheckpointManager(str(tmp_path / "full"), async_save=True)
    try:
        runner = steps.make_resident_chunk_runner(step, FAST_BS, pool)

        def run(i):
            _, _, nf = runner(state, arrays, perm, *pools, 11, range(i, i + 1), range(i, i + 1))
            assert float(nf) == 0.0

        def replays():
            for i in range(2, 2 + n):
                run(i)
            return {k: v.clone() for k, v in state_leaves(state).items()}

        run(0)
        run(1)
        full.save(1, state)
        s1 = replays()
        ptrs = {k: v.data_ptr() for k, v in state_leaves(state).items()}
        assert full.restore(state) is state
        assert {k: v.data_ptr() for k, v in state_leaves(state).items()} == ptrs
        s2 = replays()
        assert pool.graphs[0].replays == 1 + 2 * n
        for k, v in s1.items():
            assert torch.equal(v, s2[k]), k
        params_only = CheckpointManager(str(tmp_path / "params_only"), payload="params_only")
        params_only.save(2 + n, state)
        run(2)  # moves every leaf
        params_only.restore(state)
        for k, v in state_leaves(state).items():
            if k.startswith("params/"):
                assert torch.equal(v, s2[k]), k
            else:
                assert not v.any(), k
        params_only.close()
    finally:
        full.close()
        pool.close()


# ---------------------------------------------------------------------------
# C2DSR: the view passes through the kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backbone", ["sasrec", "bert4rec", "gru4rec"])
def test_c2dsr_step_on_cuda_equals_the_plain_model_s(gen, backbone):
    """One dense C2DSR phase-A step of a kernels='cuda' model against the
    same step of a kernels='torch' model from the same weights, batch and
    key, dropout on (both view passes draw one set of masks on both): the
    views (2L) go through the kernels, so the attention launches 12 forwards
    and 12 backwards (4 a pass: main, all_seq, corrupted), the gather 4 (2
    for the main forward, 1 a view pass), the scoring head 3."""
    cfg = _backbone_cfg(backbone, is_c2dsr=True, sasrec_heads=2)
    model = build_model(cfg)
    plain = build_model(dataclasses.replace(cfg, kernels="torch"), device="cuda")
    plain.load_state_dict(model.state_dict())
    v = cfg.item_table_size
    batch = _step_batch(v, gen)
    pools = torch.arange(v, device="cuda").repeat(2, 1)
    sizes = torch.tensor([v, v], device="cuda")
    metrics = []
    for m, attn, gathers in ((model, 12 * (backbone != "gru4rec"), 4), (plain, 0, 0)):
        state = steps.init_state(m, Adam(1e-3))
        step = steps.make_train_step(m, Adam(1e-3), dr_e_w=0.1, c2dsr_w=0.1)
        before = launches.read()
        _, out = step(state, batch, pools, sizes, 5)
        got = launches.since(before)
        assert got["attention_fwd"] == got["attention_bwd"] == attn, got
        assert got["embedding_gather"] == gathers and got["scoring_head"] == 3 * bool(gathers)
        metrics.append(out)
    assert "loss_cl" in metrics[0]
    for k, val in metrics[0].items():
        assert torch.isfinite(val) and abs(float(val) - float(metrics[1][k])) <= LOSS_TOL, k
    for (name, p), q in zip(model.named_parameters(), plain.parameters()):
        if name.endswith(".k.bias") or name.endswith("in_proj_bias"):
            continue  # a zero gradient up to rounding (see above)
        torch.testing.assert_close(p, q, atol=1e-5, rtol=1e-4, msg=name)


def test_replayed_c2dsr_steps_equal_eager_steps(gen):
    """Four C2DSR phase-A steps through a resident chunk runner against the
    same steps taken eagerly, dropout 0.5 and the samplers on: the graph
    registers the corrupted items' and both views' generators, so a replay
    draws what the eager step draws (12 attention forwards and backwards a
    replay)."""
    cfg = _fast_cfg(is_c2dsr=True)
    ds = synth_packed(cfg, np.random.default_rng(0), 4 * FAST_BS)
    made = []
    for _ in range(2):
        model = build_model(cfg, seed=0)
        state = steps.init_state(model, Adam(1e-3))
        made.append((state, steps.make_train_step(model, Adam(1e-3), dr_e_w=0.1,
                                                  c2dsr_w=0.1)))
    (est, estep), (gst, gstep) = made
    assert len(gstep.rng.generators()) == 5
    arrays = loop._resident(ds.batch_arrays(), "cuda")
    pools = loop._device_pools(ds, "cuda")
    perm = torch.as_tensor(np.random.default_rng(1).permutation(4 * FAST_BS).astype(np.int32),
                           device="cuda")
    pool = GraphPool("cuda")
    try:
        runner = steps.make_resident_chunk_runner(gstep, FAST_BS, pool)
        for i in range(4):
            _, m0, nf = runner(gst, arrays, perm, *pools, 9, range(i, i + 1), range(i, i + 1))
            rows = perm[i * FAST_BS:(i + 1) * FAST_BS]
            _, m = estep(est, {k: x.index_select(0, rows) for k, x in arrays.items()},
                         *pools, fold_in(9, i))
            assert float(nf) == 0.0 and "loss_cl" in m0
            for k, x in m0.items():
                assert abs(float(x) - float(m[k])) <= LOSS_TOL, (i, k, float(x), float(m[k]))
        graph = pool.graphs[0]
        assert graph.replays == 3
        assert graph.captured["attention_fwd"] == graph.captured["attention_bwd"] == 12
        got, want = _moments(gst, "A", "dense"), _moments(est, "A", "dense")
        for k in ("table_mu", "table_nu"):
            assert _rel_to_max(got[k], want[k]) <= MOMENT_TOL, k
        for k, x in got["dense"].items():
            assert _rel_to_max(x, want["dense"][k]) <= MOMENT_TOL, k
    finally:
        pool.close()


def test_profiled_phase_a_is_the_c2dsr_step_run_seed_trains(gen):
    """`profile_step.step_kinds` (what `chip_smoke.py` times) builds phase A
    as `run_seed` does: with C2DSR its step runs the two view passes, 12
    attention forwards and 12 backwards where the plain phase A has 4."""
    from amid_tpu_torch.profile_step import step_kinds

    cfg = _backbone_cfg("bert4rec", is_c2dsr=True)
    ds = synth_packed(cfg, np.random.default_rng(0), 2 * cfg.batch_size)
    for c2dsr, attn in ((True, 12), (False, 4)):
        c = dataclasses.replace(cfg, is_c2dsr=c2dsr)
        fn, per_call = step_kinds(c, TrainConfig(model=c, data=DataConfig(neg_nums=9)), ds,
                                  False)["phase_a"]
        before = launches.read()
        fn()
        got = launches.since(before)
        assert per_call == 1
        assert got["attention_fwd"] + got["attention_fwd_long"] == attn, got
        assert got["attention_bwd"] + got["attention_bwd_long"] == attn, got


def test_c2dsr_bert4rec_with_both_comps_trains_on_the_long_forward(gen):
    """BERT4Rec with InnerComp, InterComp and C2DSR at L=150 attends over
    T=600 on its main pass and T=1,200 on its views at dh=32, past the
    one-head forward's T<=800: `build_model` builds it on the card, and one
    dense phase-A step at B=2 equals the kernels='torch' step from the same
    weights, batch and key (dropout on): its 12 forward launches on the
    paths `forward_route` takes (the views' 8 on the long forward), its 12
    backward on the long backward. `loss_cl` (about 30) and the loss that
    holds it at LOSS_TOL relative, as chip_smoke.py's `losses_agree`; the
    updated parameters element-wise at 1e-6 with at most 1e-3 of them apart
    (Adam's first update is about lr * sign(g))."""
    cfg = ModelConfig(backbone="bert4rec", emb_dim=128, bert_heads=4, seq_len=150,
                      batch_size=2, hid_dim=8, is_inc=True, is_itc=True, is_dr=True,
                      is_c2dsr=True, item_length=50, user_length=50)
    assert cfg.enc_seq_len == 1200 and forward_route(1200, 32) == "long"
    model = build_model(cfg)
    plain = build_model(dataclasses.replace(cfg, kernels="torch"), device="cuda")
    plain.load_state_dict(model.state_dict())
    v = cfg.item_table_size
    batch = _step_batch(v, gen, bsz=2, t=150)
    pools = torch.arange(v, device="cuda").repeat(2, 1)
    sizes = torch.tensor([v, v], device="cuda")
    main_long = forward_route(600, 32) == "long"
    metrics = []
    for m, kernels in ((model, True), (plain, False)):
        state = steps.init_state(m, Adam(1e-3))
        step = steps.make_train_step(m, Adam(1e-3), dr_e_w=0.1, c2dsr_w=0.1)
        before = launches.read()
        _, out = step(state, batch, pools, sizes, 5)
        got = launches.since(before)
        assert got["attention_fwd_long"] == kernels * (8 + 4 * main_long), got
        assert got["attention_fwd"] == kernels * 4 * (not main_long), got
        assert got["attention_bwd_long"] == 12 * kernels and got["attention_bwd"] == 0, got
        metrics.append(out)
    assert "loss_cl" in metrics[0]
    for k, val in metrics[0].items():
        ref = float(metrics[1][k])
        scale = max(1.0, abs(ref)) if k in ("loss_cl", "loss") else 1.0
        assert torch.isfinite(val) and abs(float(val) - ref) <= LOSS_TOL * scale, k
    for (name, p), q in zip(model.named_parameters(), plain.parameters()):
        if name.endswith(".k.bias"):
            continue  # a zero gradient up to rounding (see above)
        share = ((p - q).abs() > 1e-6).float().mean().item()
        assert share <= 1e-3, (name, share)


# ---------------------------------------------------------------------------
# the precision flags: the bf16-operand modes and remat
# ---------------------------------------------------------------------------

def _chip_smoke():
    """The repository root's `chip_smoke.py`, whose fp64 oracles, readings and
    per-case limits (BF16_LIMITS) the bf16 cases share."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("b,t,heads,kind,rate,path,case,d", [
    (64, 150, 8, "causal", 0.5, "sweep", "causal_T150_h8_rate0.5", 128),
    (256, 20, 8, "causal", 0.0, "sweep", "causal_T20_h8_rate0.0", 128),
    (32, 600, 4, "keypad", 0.1, "long", "long_keypad_T600_h4_rate0.1", 128),
    # the native bf16 long paths at every head width, both biases, both
    # rates, T of 300, 600 and 1,000 (none a multiple of a stage), held to
    # one pair of limits (chip_smoke.py's "bf16_long_native" cases)
    (8, 300, 16, "keypad", 0.0, "long", "long_native", 128),
    (8, 600, 16, "causal", 0.1, "long", "long_native", 128),
    (8, 1000, 8, "causal", 0.1, "long", "long_native", 128),
    (8, 1000, 8, "keypad", 0.0, "long", "long_native", 128),
    (8, 300, 4, "causal", 0.0, "long", "long_native", 128),
    (8, 1000, 4, "keypad", 0.1, "long", "long_native", 128),
    (8, 1000, 2, "keypad", 0.1, "long", "long_native", 128),
    (8, 600, 2, "causal", 0.0, "long", "long_native", 128),
    # dh 128 and dh 12 (template 16): the native long kernels and the one-head
    # builds at the widths of configurations (a) and (b)
    (8, 300, 1, "keypad", 0.1, "long", "long_native", 128),
    (8, 600, 4, "causal", 0.0, "long", "long_native", 512),
    (8, 1000, 8, "keypad", 0.1, "long", "long_native", 96),
    (64, 150, 8, "causal", 0.5, "sweep", "causal_T150_h8_rate0.5", 96),
    # template width 256 (the AMID_BF16_WIDE builds): dh 256, and 160 and
    # 136 (padded), configuration (d)'s width at T=300, 1,000 and 37
    (8, 300, 4, "keypad", 0.1, "long", "long_dh256", 1024),
    (8, 1000, 2, "causal", 0.0, "long", "long_dh256", 512),
    (8, 600, 1, "causal", 0.1, "long", "long_dh256", 160),
    (8, 37, 2, "keypad", 0.0, "long", "long_dh256", 272)])
def test_bf16_attention_modes_match_their_plain_versions(gen, b, t, heads, kind, rate, path,
                                                         case, d):
    """The forward's and the backward's bf16 builds on one path within
    chip_smoke.py's limits for the case: against the fp64 oracle of their
    own rounding points, the plain versions with `mxu_bf16=True` and the
    oracle of the JAX kernel's, with the fp32 builds at the same inputs
    outside the oracle limit (so the bf16 builds ran); two calls bit-equal;
    the launches count in the bf16 builds' counts only (on the long path
    the pre-pass runs inside each call)."""
    cs = _chip_smoke()
    dh = d // heads
    q, k, v, dout = (torch.randn(b, t, d, device="cuda", generator=gen) for _ in range(4))
    bias = _bias(kind, b, t, gen)
    before = launches.read()
    out, m, inv = attention_ops._launch_forward(q, k, v, bias, 7, heads, rate, True, path,
                                                bf16=True)
    want, wm, winv = attention_fwd_stats_plain(q, k, v, bias, 7, heads, rate, True)
    torch.testing.assert_close(m, wm, atol=LONG_MAX_ATOL, rtol=1e-6)
    torch.testing.assert_close(inv, winv, atol=LONG_INV_SUM_ATOL, rtol=1e-6)
    assert torch.equal(attention_ops._launch_forward(q, k, v, bias, 7, heads, rate, True,
                                                     path, bf16=True)[0], out)
    got = attention_ops._launch_backward(q, k, v, bias, want, wm, winv, dout, 7, heads, rate,
                                         path, bf16=True)
    again = attention_ops._launch_backward(q, k, v, bias, want, wm, winv, dout, 7, heads, rate,
                                           path, bf16=True)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    counted = {n: c for n, c in launches.since(before).items() if c}
    suffix = "_long" if path == "long" else ""
    assert counted == {f"attention_fwd{suffix}_bf16": 2, f"attention_bwd{suffix}_bf16": 2}

    args = (q, k, v, bias, 7, heads, rate)
    fwd = cs.Bf16Readings()
    fwd.draw([(out, attention_ops._launch_forward(*args, False, path)[0], want,
               cs.bf16_attention_kernel_oracle(torch, *args, cs.key_chunk(path, dh)),
               cs.bf16_attention_oracle(torch, *args))])
    fwd.verdict(f"bf16_{case}")
    plain = attention_bwd_plain(q, k, v, bias, want, wm, winv, dout, 7, heads, rate, True)
    fp32 = attention_ops._launch_backward(q, k, v, bias, want, wm, winv, dout, 7, heads, rate,
                                          path)
    oracle = cs.bf16_attention_bwd_oracle(torch, q, k, v, bias, want, dout, 7, heads, rate)
    bwd = cs.Bf16Readings()
    bwd.draw(list(zip(got, fp32, plain, oracle, oracle)))
    bwd.verdict(f"bf16_bwd_{case}")


def _bf16_limits(dh):
    """The longest T of the bf16 one-head forward and of the bf16 one-sweep
    backward at head width `dh`, asked of the kernels' own shared-memory
    functions (T up to 4,096) after a launch has bound them."""
    fused_attention(*(torch.zeros(1, 8, 16, device="cuda") for _ in range(3)),
                    torch.zeros(1, 1, 1, 8, device="cuda"), 0, 1, 0.0, True)
    out = []
    for lib, fn in (("attention_fwd_bf16", "attention_fwd_smem_bytes"),
                    ("attention_bwd_bf16", "attention_bwd_smem_bytes")):
        smem = attention_ops._build.bind(getattr(attention_ops._build.load(lib), fn),
                                         [ctypes.c_int, ctypes.c_int], ctypes.c_size_t)
        out.append(max(n for n in range(1, 4097) if smem(n, dh) <= attention_ops.SMEM_LIMIT))
    return out


@pytest.mark.parametrize("t", [20, 150, "limit"])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("kind", ["causal", "keypad"])
@pytest.mark.parametrize("dh", [8, 12, 16, 32, 64, 128])
def test_bf16_one_head_pair_at_every_width_matches_its_plain_versions(gen, dh, kind, rate, t):
    """The native bf16 one-head forward and one-sweep backward at every
    template width and at dh=12 (configuration (b)'s, padded to 16), both
    biases, rates 0 and 0.5, at T=20, T=150 and the longest T each kernel
    holds at that width ("limit": the forward's and the backward's own; at
    dh=128 the backward holds T <= 128, its T=150 case runs there):
    within chip_smoke.py's limits of the one-head case at that T and rate
    (the backward: rate 0 the T=20 case's, dropout the T=150 case's, as the
    width phase holds them) against the fp64 oracle of their own rounding
    points, the plain versions with `mxu_bf16=True` and the oracle of the
    JAX kernel's, with the fp32 mode outside the oracle limit (on the path
    its route takes: its one-head kernels hold shorter heads); the row
    statistics against the plain ones; two calls bit-equal; one launch of
    each in its bf16 count."""
    cs = _chip_smoke()
    b, heads = 2, 2
    d = dh * heads
    t_fwd, t_bwd = _bf16_limits(dh)
    if t != "limit":
        t_fwd, t_bwd = t, min(t, t_bwd)
    for direction, n in (("fwd", t_fwd), ("bwd", t_bwd)):
        q, k, v, dout = (torch.randn(b, n, d, device="cuda", generator=gen) for _ in range(4))
        bias = _bias(kind, b, n, gen)
        args = (q, k, v, bias, 9, heads, rate)
        want, wm, winv = attention_fwd_stats_plain(*args, True)
        before = launches.read()
        if direction == "fwd":
            out, m, inv = attention_ops._launch_forward(*args, True, "sweep", bf16=True)
            assert torch.equal(attention_ops._launch_forward(*args, False, "sweep",
                                                             bf16=True)[0], out)
            counted = {c: x for c, x in launches.since(before).items() if x}
            torch.testing.assert_close(m, wm, atol=LONG_MAX_ATOL, rtol=1e-6)
            torch.testing.assert_close(inv, winv, atol=LONG_INV_SUM_ATOL, rtol=1e-6)
            readings = cs.Bf16Readings()
            readings.draw([(out, attention_ops._launch_forward(*args, False)[0], want,
                            cs.bf16_attention_kernel_oracle(torch, *args,
                                                            cs.key_chunk("sweep", dh)),
                            cs.bf16_attention_oracle(torch, *args))])
            readings.verdict(f"fwd dh={dh} {kind} T={n} rate={rate}",
                             f"bf16_causal_T{20 if n <= 20 else 150}_h8_rate{rate}")
        else:
            got = attention_ops._launch_backward(q, k, v, bias, want, wm, winv, dout, 9, heads,
                                                 rate, "sweep", bf16=True)
            assert all(torch.equal(a, g) for a, g in zip(attention_ops._launch_backward(
                q, k, v, bias, want, wm, winv, dout, 9, heads, rate, "sweep", bf16=True), got))
            counted = {c: x for c, x in launches.since(before).items() if x}
            fp32 = attention_ops._launch_backward(q, k, v, bias, want, wm, winv, dout, 9, heads,
                                                  rate)
            plain = attention_bwd_plain(q, k, v, bias, want, wm, winv, dout, 9, heads, rate,
                                        True)
            oracle = cs.bf16_attention_bwd_oracle(torch, q, k, v, bias, want, dout, 9, heads,
                                                  rate)
            readings = cs.Bf16Readings()
            readings.draw(list(zip(got, fp32, plain, oracle, oracle)))
            readings.verdict(f"bwd dh={dh} {kind} T={n} rate={rate}",
                             "bf16_bwd_causal_T150_h8_rate0.5" if rate > 0 else
                             "bf16_bwd_causal_T20_h8_rate0.0")
        assert counted == {f"attention_{direction}_bf16": 2}, counted


@pytest.mark.parametrize("dh", attention_ops.KERNEL_HEAD_DIMS)
def test_bf16_routes_read_the_bf16_kernels_own_limits(gen, dh):
    """`forward_max_t(dh, "bf16")` and `sweep_fits(.., "bf16")` are the bf16
    kernels' own longest T, not the fp32 kernels'; the one-head bf16
    launches run at those T, refuse one more, and the bf16 routes send
    one more to the long paths."""
    t_fwd, t_bwd = _bf16_limits(dh)
    assert attention_ops.forward_max_t(dh, "bf16") == t_fwd != attention_ops.forward_max_t(dh)
    assert attention_ops.sweep_fits(t_bwd, dh, "bf16")
    assert not attention_ops.sweep_fits(t_bwd + 1, dh, "bf16")
    assert attention_ops.forward_route(t_fwd + 1, dh, "bf16") == "long"
    assert attention_ops.backward_route(t_bwd + 1, dh, "bf16") == "long"
    for n, direction, fits in ((t_fwd, "fwd", True), (t_fwd + 1, "fwd", False),
                               (t_bwd, "bwd", True), (t_bwd + 1, "bwd", False)):
        q, k, v, dout = (torch.randn(1, n, dh, device="cuda", generator=gen) for _ in range(4))
        bias = _bias("causal", 1, n, gen)
        if direction == "fwd":
            def launch():
                return attention_ops._launch_forward(q, k, v, bias, 0, 1, 0.0, False, "sweep",
                                                     bf16=True)[:1]
        else:
            res = attention_fwd_stats_plain(q, k, v, bias, 0, 1, 0.0, True)

            def launch():
                return attention_ops._launch_backward(q, k, v, bias, *res, dout, 0, 1, 0.0,
                                                      "sweep", bf16=True)
        if fits:
            assert all(torch.isfinite(x).all() for x in launch()), (direction, n)
        else:
            with pytest.raises(ValueError, match="shared memory"):
                launch()
    torch.cuda.synchronize()


def test_bf16_long_paths_pack_a_padded_width_to_whole_k16_steps(gen, monkeypatch):
    """dh=24 packs to 32 columns (`bf16_packed_shape`): the scratch of a long
    bf16 forward holds q, k and v as `pack_bf16_plain` packs them, bit for
    bit (the padding columns zero), and the call agrees with its plain
    version; the same at dh=6 (16 columns), whose rows do not start on 16
    bytes."""
    make = attention_ops._long_bf16_scratch
    for heads, d, dhp in ((4, 96, 32), (4, 24, 16)):
        b, t = 2, 300
        assert attention_ops.bf16_packed_shape(t, d // heads) == (384, dhp)
        q, k, v = (torch.randn(b, t, d, device="cuda", generator=gen) for _ in range(3))
        bias = _bias("keypad", b, t, gen)
        kept = []
        monkeypatch.setattr(attention_ops, "_long_bf16_scratch",
                            lambda *a: kept.append(make(*a)) or kept[-1])
        out = attention_ops._launch_forward(q, k, v, bias, 0, heads, 0.0, False, "long",
                                            bf16=True)[0]
        torch.cuda.synchronize()
        region = b * heads * 384 * dhp
        packed = kept[0][:3 * region * 2].view(torch.bfloat16)
        for i, x in enumerate((q, k, v)):
            want = attention_ops.pack_bf16_plain(x, heads).reshape(-1)
            assert torch.equal(packed[i * region:(i + 1) * region], want), (d, i)
        plain = attention_fwd_stats_streamed_plain(q, k, v, bias, 0, heads, 0.0,
                                                   attention_ops.LONG_BF16_STAGE_KEYS, True)[0]
        assert ((out - plain).norm() / plain.norm()).item() < 1e-2


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["keypad", "causal"])
@pytest.mark.parametrize("t", [37, 129, 300])
@pytest.mark.parametrize("heads,d", [(2, 256), (3, 300), (1, 256), (2, 400)])
def test_bf16_long_forward_at_wide_heads_ragged_t_and_padded_widths(gen, heads, d, t, kind,
                                                                   rate):
    """The bf16 long forward at template widths 128 (dh 128, and 100
    padded) and 256 (dh 256, and 200 padded), where each block rounds its
    own Q rows and the pre-pass packs K and V alone to whole stages, at T no
    multiple of a stage or of a block's 128 rows, both biases and rates:
    within chip_smoke.py's limits of its width against the fp64 oracle of
    its rounding points and the plain version, the fp32 build outside the
    oracle limit; the row statistics against the plain ones; two calls
    bit-equal, one launch counted a call."""
    cs = _chip_smoke()
    b, dh = 2, d // heads
    q, k, v = torch.randn(b, t, 3 * d, device="cuda", generator=gen).split(d, dim=-1)
    bias = _bias(kind, b, t, gen)
    seed = torch.tensor([77], dtype=torch.int64, device="cuda")
    before = launches.read()
    got = attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, True, "long", bf16=True)
    again = attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, True, "long",
                                          bf16=True)
    assert {n: c for n, c in launches.since(before).items() if c} == {
        "attention_fwd_long_bf16": 2}
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    args = (q, k, v, bias, seed, heads, rate)
    want, wm, winv = attention_fwd_stats_plain(*args, True)
    torch.testing.assert_close(got[1], wm, atol=LONG_MAX_ATOL, rtol=1e-6)
    torch.testing.assert_close(got[2], winv, atol=LONG_INV_SUM_ATOL, rtol=1e-6)
    readings = cs.Bf16Readings()
    readings.draw([(got[0], attention_ops._launch_forward(*args, False, "long")[0],
                    attention_fwd_stats_streamed_plain(*args, attention_ops.LONG_BF16_STAGE_KEYS,
                                                       True)[0],
                    cs.bf16_attention_kernel_oracle(torch, *args, cs.key_chunk("long", dh)),
                    cs.bf16_attention_oracle(torch, *args))])
    readings.verdict(f"bf16_long_{kind}_T{t}_dh{dh}",
                     "bf16_long_dh256" if dh > 128 else "bf16_long_native")


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["keypad", "causal"])
@pytest.mark.parametrize("t", [37, 129, 300])
@pytest.mark.parametrize("heads,d", [(1, 256), (2, 512), (1, 200), (2, 400)])
def test_fp32_long_forward_at_head_width_256_ragged_t(gen, heads, d, t, kind, rate):
    """The fp32 long forward at template width 256 (64 queries a block, the
    warpgroups on the two halves of the head width; dh 256, and 200 on the
    padded build), at T no multiple of its 16-key stages or 64-row blocks,
    both biases and rates: against the plain version in key tiles of 16 at
    ATOL / RTOL, the row statistics at the long forward's tolerances, two
    calls bit-equal, one launch counted a call."""
    b = 2
    q, k, v = torch.randn(b, t, 3 * d, device="cuda", generator=gen).split(d, dim=-1)
    bias = _bias(kind, b, t, gen)
    seed = torch.tensor([77], dtype=torch.int64, device="cuda")
    before = fused_attention.long_forward_launches
    got = attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, True, "long")
    again = attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, True, "long")
    assert fused_attention.long_forward_launches == before + 2
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    want = attention_fwd_stats_streamed_plain(q, k, v, bias, seed, heads, rate, 16)
    torch.testing.assert_close(got[0], want[0], atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got[1], want[1], atol=LONG_MAX_ATOL, rtol=1e-6)
    torch.testing.assert_close(got[2], want[2], atol=LONG_INV_SUM_ATOL, rtol=1e-6)


def test_replayed_d512_bert4rec_steps_equal_eager_steps(gen):
    """Configuration (a)'s width: BERT4Rec at emb_dim 512 (4 heads of 128)
    and T=150 (encoder T=300, both long paths at dh=128), dense phase-A
    steps replayed bit-equal to eager ones."""
    cfg = dataclasses.replace(_fast_cfg(backbone="bert4rec"), emb_dim=512, seq_len=150)
    _bit_equal_replays(cfg, {"attention_fwd_long": 4, "attention_bwd_long": 4})


def test_bf16_scoring_pair_matches_its_plain_version(gen):
    """K5's bf16 build within chip_smoke.py's limits for C=1000, the fp32
    build at the same inputs outside the oracle limit; one bf16 launch; two
    calls bit-equal."""
    cs = _chip_smoke()
    b, c, d, h = 64, 1000, 128, 32
    fc1 = torch.randn(h, 2 * d, device="cuda", generator=gen) * (2 * d) ** -0.5
    params = (fc1[:, :d], fc1[:, d:], torch.randn(h, device="cuda", generator=gen) * 0.1,
              torch.randn(1, h, device="cuda", generator=gen) * h ** -0.5,
              torch.randn(1, device="cuda", generator=gen))
    u1, u2 = (torch.randn(b, d, device="cuda", generator=gen) for _ in range(2))
    items = torch.randn(b, c, d, device="cuda", generator=gen)
    before = scoring_head.bf16_launches
    got = scoring_head_pair(u1, u2, items, *params, bf16=True)
    assert scoring_head.bf16_launches == before + 1
    assert all(torch.equal(a, g) for a, g in zip(scoring_head_pair(u1, u2, items, *params,
                                                                   bf16=True), got))
    want = scoring_head_pair_plain(u1, u2, items, *params, bf16=True)
    fp32 = scoring_head_pair(u1, u2, items, *params)
    oracles = [cs.bf16_scoring_oracle(torch, u, items, *params) for u in (u1, u2)]
    readings = cs.Bf16Readings()
    readings.draw(list(zip(got, fp32, want, oracles, oracles)))
    readings.verdict("bf16_scoring_pair_C1000")


def test_bf16_gemm_form_matches_the_cpu_form(gen):
    """`ops.precision`'s bf16 products on the card (a GEMM of bf16 operands
    with an fp32 output) against the CPU form (rounded operands, an exact
    fp32 product), forward and both gradients: the same products, summed in
    another order."""
    from amid_tpu_torch.ops import precision

    cases = [((300, 128), (96, 128), "linear"), ((4, 8, 150, 16), (4, 8, 16, 150), "matmul")]
    for sa, sb, kind in cases:
        a, w = (torch.randn(*s, device="cuda", generator=gen) for s in (sa, sb))
        outs = []
        for dev in ("cuda", "cpu"):
            x, y = (t.to(dev).requires_grad_() for t in (a, w))
            out = (precision.linear(x, y, None, "bf16") if kind == "linear"
                   else precision.matmul(x, y, "bf16"))
            g = torch.ones_like(out)
            outs.append((out, *torch.autograd.grad(out, (x, y), g)))
        for got, want in zip(*outs):
            torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-5)


def _bit_equal_replays(cfg, expect):
    """Four dense phase-A steps through a resident chunk runner against the
    same steps taken eagerly: losses and every moment bit-equal; the launches
    a replay captured."""
    ds = synth_packed(cfg, np.random.default_rng(0), 4 * FAST_BS)
    (_, est, estep), (_, gst, gstep) = _fast_pair("dense", "A", cfg)
    arrays = loop._resident(ds.batch_arrays(), "cuda")
    pools = loop._device_pools(ds, "cuda")
    perm = torch.as_tensor(np.random.default_rng(1).permutation(4 * FAST_BS).astype(np.int32),
                           device="cuda")
    pool = GraphPool("cuda")
    try:
        runner = steps.make_resident_chunk_runner(gstep, FAST_BS, pool)
        for i in range(4):
            _, m0, nf = runner(gst, arrays, perm, *pools, 9, range(i, i + 1), range(i, i + 1))
            rows = perm[i * FAST_BS:(i + 1) * FAST_BS]
            _, m = estep(est, {k: x.index_select(0, rows) for k, x in arrays.items()},
                         *pools, fold_in(9, i))
            assert float(nf) == 0.0
            for k, x in m0.items():
                assert torch.equal(x, m[k]), (i, k, float(x), float(m[k]))
        graph = pool.graphs[0]
        assert graph.replays == 3
        assert {n: c for n, c in graph.captured.items() if c and "attention" in n} == expect
        for name, mu in gst.opt_state.mu.items():
            assert torch.equal(mu, est.opt_state.mu[name]), name
            assert torch.equal(gst.opt_state.nu[name], est.opt_state.nu[name]), name
    finally:
        pool.close()


def test_replayed_remat_steps_equal_eager_steps(gen):
    """Dropout 0.5: each remat region keeps its draws, so the recompute inside
    the captured backward replays the forward's masks; 8 attention forwards a
    step (4 and their recompute), 4 backwards."""
    _bit_equal_replays(_fast_cfg(remat=True), {"attention_fwd": 8, "attention_bwd": 4})


def test_replayed_bf16_steps_equal_eager_steps(gen):
    _bit_equal_replays(_fast_cfg(use_bf16=True),
                       {"attention_fwd_bf16": 4, "attention_bwd_bf16": 4})


def test_replayed_bf16_bert4rec_steps_equal_eager_steps(gen):
    """`--bf16` BERT4Rec at T=150 (encoder T=300, dh=32): the paths the bf16
    routes take there (both native long paths), their packed scratch from
    the caching allocator inside the capture, replays bit-equal to eager
    steps."""
    cfg = dataclasses.replace(_fast_cfg(use_bf16=True, backbone="bert4rec"), emb_dim=128,
                              seq_len=150)
    fwd = "attention_fwd_long_bf16" if forward_route(300, 32, "bf16") == "long" else (
        "attention_fwd_bf16")
    bwd = "attention_bwd_long_bf16" if attention_ops.backward_route(300, 32, "bf16") == (
        "long") else "attention_bwd_bf16"
    _bit_equal_replays(cfg, {fwd: 4, bwd: 4})
