"""The long-sequence attention forward on the CPU: its plain version
(`attention_fwd_stats_streamed_plain`, an online softmax over key tiles in
the order of `csrc/attention_fwd_long.cu`) against the whole-row plain
version and the JAX package's `fused_attention` in Pallas interpret mode;
the backward fed its statistics against autograd; `forward_route`'s rule;
and the long launch's argument block with the entry point replaced by a
recorder (the kernel itself runs on the card only: `tests/test_torch_cuda.py`).

Tolerances: out at ATOL 1e-5, RTOL 1e-4 (fp32 on both sides, the card's
kernel-vs-plain tolerance); the row statistics at 1e-6 absolute and
relative (chip_smoke.py's STATS_ATOL, STATS_RTOL: the tiles' maxima are the
same scores' maxima, the sums of exp are taken in another order); the
backward at the card's 2e-5 (BWD_ATOL)."""

import struct

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from amid_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from amid_tpu_torch.ops import attention as attention_ops
from amid_tpu_torch.ops.attention import (
    attention_bwd_plain,
    attention_fwd_stats_plain,
    attention_fwd_stats_streamed_plain,
    attention_plain,
)
from test_torch_attention_stats import _causal, _fake_entry, _keypad_row0_masked
from test_torch_c2dsr import kernel_limits  # noqa: F401 (a fixture)

ATOL, RTOL = 1e-5, 1e-4
STATS_ATOL, STATS_RTOL = 1e-6, 1e-6
BWD_ATOL = 2e-5
T, BLOCK_K = 37, 8  # four whole key tiles and a partial fifth


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _inputs(rng, bias_kind, b=3, t=T, d=32):
    q, k, v = (rng.normal(size=(b, t, d)).astype(np.float32) for _ in range(3))
    bias = _causal(t) if bias_kind == "causal" else _keypad_row0_masked(rng, b, t)
    return (q, k, v, bias), [torch.tensor(x) for x in (q, k, v, bias)]


@pytest.mark.parametrize("bias_kind,heads,rate", [
    ("causal", 4, 0.0), ("keypad", 2, 0.0), ("causal", 2, 0.5), ("keypad", 4, 0.5),
])
def test_streamed_matches_the_whole_row_plain_version_and_jax(rng, bias_kind, heads, rate):
    arrays, (q, k, v, bias) = _inputs(rng, bias_kind)
    got = attention_fwd_stats_streamed_plain(q, k, v, bias, 7, heads, rate, BLOCK_K)
    want = attention_fwd_stats_plain(q, k, v, bias, 7, heads, rate)
    torch.testing.assert_close(got[0], want[0], atol=ATOL, rtol=RTOL)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, atol=STATS_ATOL, rtol=STATS_RTOL)
    torch.testing.assert_close(got[0], attention_plain(q, k, v, bias, 7, heads, rate),
                               atol=ATOL, rtol=RTOL)
    if rate == 0.0:  # the TPU's dropout bits are its own: only rate 0 compares
        with pltpu.force_tpu_interpret_mode():
            jax_out = jax_fused_attention(*map(jnp.asarray, arrays),
                                          jnp.zeros((1,), jnp.int32), heads, 0.0)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(jax_out), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("block_k", [1, 8, 36, 37, 64])
def test_streamed_fully_masked_row_is_uniform_over_the_real_keys(rng, block_k):
    """Batch row 0 masks every key: row_max is exactly -1e9 (the scores round
    to it) and P = 1/T over the T real keys, whatever the tiling, as
    `test_sweep_on_a_fully_masked_row_matches_autograd` holds the whole-row
    version; the output is the mean of v."""
    heads = 2
    _, (q, k, v, bias) = _inputs(rng, "keypad")
    out, row_max, row_inv_sum = attention_fwd_stats_streamed_plain(q, k, v, bias, 0, heads,
                                                                   0.0, block_k)
    assert torch.equal(row_max[0], torch.full((heads, T), -1e9))
    s = attention_ops._scores(q, k, bias, heads)
    p_row0 = torch.exp(s[0] - row_max[0, ..., None]) * row_inv_sum[0, ..., None]
    torch.testing.assert_close(p_row0, torch.full((heads, T, T), 1.0 / T), atol=1e-7, rtol=0)
    torch.testing.assert_close(out[0], v[0].mean(dim=0, keepdim=True).expand(T, -1),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("bias_kind,rate", [("causal", 0.0), ("keypad", 0.5)])
def test_backward_fed_the_streamed_statistics_matches_autograd(rng, bias_kind, rate):
    heads = 4
    _, (q, k, v, bias) = _inputs(rng, bias_kind)
    dout = torch.tensor(rng.normal(size=tuple(q.shape)).astype(np.float32))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(attention_plain(*leaves, bias, 5, heads, rate), leaves, dout)
    res = attention_fwd_stats_streamed_plain(q, k, v, bias, 5, heads, rate, BLOCK_K)
    got = attention_bwd_plain(q, k, v, bias, *res, dout, 5, heads, rate)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=BWD_ATOL, rtol=RTOL)


def test_forward_route_takes_the_long_path_beyond_the_one_head_kernel(kernel_limits,
                                                                      monkeypatch):
    """'long' where the shared memory of the mode's one-head kernel cannot
    hold the head (`forward_max_t`: in fp32 800 at dh=32, 1,448 at dh=16; in
    bf16 1,440 and 2,400) or from `LONG_FWD_FASTER_FROM[mode][dh]` on;
    'sweep' otherwise."""
    monkeypatch.setattr(attention_ops, "LONG_FWD_FASTER_FROM", {"fp32": {}, "bf16": {}})
    limits = {"fp32": ((8, 2416), (16, 1448), (32, 800), (64, 424)),  # each mode's own kernel
              "bf16": ((8, 2400), (16, 2400), (32, 1440), (64, 800))}
    for mode, pairs in limits.items():
        for dh, limit in pairs:
            assert attention_ops.forward_route(limit, dh, mode) == "sweep"
            assert attention_ops.forward_route(limit + 1, dh, mode) == "long"
    monkeypatch.setattr(attention_ops, "LONG_FWD_FASTER_FROM", {"fp32": {32: 300}, "bf16": {}})
    assert attention_ops.forward_route(299, 32) == "sweep"
    assert attention_ops.forward_route(300, 32) == attention_ops.forward_route(1200, 32) == "long"
    assert attention_ops.forward_route(300, 16) == "sweep"  # another width keeps its own rule
    assert attention_ops.forward_route(300, 32, "bf16") == "sweep"  # another mode its own table


def test_every_measured_crossover_is_within_the_one_head_kernel(kernel_limits):
    """The table holds only shapes both paths take: a T past the one-head
    kernel's limit is long by the limit alone."""
    assert set(attention_ops.LONG_FWD_FASTER_FROM) == set(attention_ops.MODES)
    for mode, table in attention_ops.LONG_FWD_FASTER_FROM.items():
        for dh, start in table.items():
            assert dh in attention_ops.KERNEL_HEAD_DIMS
            assert start <= attention_ops.forward_max_t(dh, mode)


def test_long_launch_packs_the_forward_block_and_counts_apart(monkeypatch):
    """The long path packs the one-head kernel's FwdArgs block, then its
    scratch (as many bytes as `attention_fwd_long_scratch` asks, 16-byte
    aligned), counts in `long_forward_launches` (not `launches`) and copies
    a view whose rows do not start on 16 bytes (its copies read 16-byte
    chunks)."""
    seen = _fake_entry(monkeypatch)
    b, t, d, heads = 2, 5, 16, 2
    q, k, v = torch.randn(b, t, 3 * d).split(d, dim=-1)
    bias = torch.zeros(b, 1, 1, t)
    sweeps = attention_ops.fused_attention.launches
    longs = attention_ops.fused_attention.long_forward_launches
    out, row_max, row_inv_sum = attention_ops._launch_forward(q, k, v, bias, 9, heads, 0.5,
                                                              True, path="long")
    f = struct.unpack("<24q2d2q", seen[-1])
    assert f[:7] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), row_max.data_ptr(), row_inv_sum.data_ptr())
    assert f[7:17] == (b, t, d, heads) + (3 * d * t, 3 * d) * 3
    assert f[26] % 16 == 0 and f[27] == 64
    assert attention_ops.fused_attention.long_forward_launches == longs + 1
    assert attention_ops.fused_attention.launches == sweeps
    odd = torch.randn(b, t, d + 1)[..., 1:]  # rows start 4 bytes past a 16-byte boundary
    attention_ops._launch_forward(odd, k, v, bias, 0, heads, 0.0, False, path="long")
    f = struct.unpack("<24q2d2q", seen[-1])
    assert f[0] != odd.data_ptr() and f[11:13] == (t * d, d)  # a contiguous copy
    with pytest.raises(ValueError, match="'sweep' or 'long'"):
        attention_ops._launch_forward(q, k, v, bias, 0, heads, 0.0, False, path="short")
