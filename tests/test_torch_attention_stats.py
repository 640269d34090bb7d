"""The arithmetic of the attention kernels, on the CPU: the forward's row
statistics (`attention_fwd_stats_plain`) against `attention_plain` and the
JAX package's `fused_attention` in Pallas interpret mode; the one-sweep
backward (`attention_bwd_plain`) on a fully masked row; a numpy emulation of
the kernels' 3xTF32 tensor-core products; the argument blocks the wrappers
pack, against the C header that reads them and field by field with the entry
points replaced by a recorder."""

import ctypes
import math
import re
import struct
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from amid_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from amid_tpu_torch.ops import attention as attention_ops
from amid_tpu_torch.ops.attention import (
    attention_backward,
    attention_bwd_plain,
    attention_fwd_stats_plain,
    attention_plain,
    keep_threshold,
)

ATOL, RTOL = 1e-5, 1e-4  # fp32 on both sides; the card's kernel-vs-plain tolerance
BWD_ATOL = 2e-5  # the card's backward tolerance: dk, dv sum over up to 150 queries
HEADER = Path(attention_ops.__file__).resolve().parent.parent / "csrc" / "attention_common.cuh"


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _causal(t):
    return np.triu(np.full((t, t), -1e9, np.float32), k=1)[None, None]


def _keypad_row0_masked(rng, b, t):
    """[B, 1, 1, T] key padding, left padding, every key of batch row 0 masked."""
    lens = rng.integers(1, t + 1, b)
    ok = np.arange(t)[None, :] >= (t - lens[:, None])
    ok[0] = False
    return np.where(ok, 0.0, -1e9).astype(np.float32)[:, None, None, :]


def _probs(q, k, bias, heads):
    """softmax(S) per head, [B, h, T, T], in plain PyTorch."""
    b, t, d = q.shape
    dh = d // heads
    qh = q.view(b, t, heads, dh).transpose(1, 2)
    kh = k.view(b, t, heads, dh).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(dh)) + bias
    return s, torch.softmax(s, dim=-1)


@pytest.mark.parametrize("bias_kind,t,heads,rate", [
    ("causal", 16, 4, 0.0), ("keypad", 12, 2, 0.0), ("causal", 10, 2, 0.5),
])
def test_fwd_stats_out_matches_plain_and_jax_and_rebuilds_p(rng, monkeypatch, bias_kind, t,
                                                             heads, rate):
    """out against `attention_plain` and JAX; row_max and row_inv_sum against
    the scores the call itself computed (recorded from its `_scores`): the
    exact max and the softmax rebuilt from them. A second matmul of the same
    inputs need not agree with the first bit for bit. The inputs are
    torch-owned copies, not views of the numpy arrays JAX reads."""
    b, d = 3, 32
    q, k, v = (rng.normal(size=(b, t, d)).astype(np.float32) for _ in range(3))
    bias = _causal(t) if bias_kind == "causal" else _keypad_row0_masked(rng, b, t)
    tq, tk, tv, tb = map(torch.tensor, (q, k, v, bias))
    scores, real = [], attention_ops._scores

    def recorded(*args):
        scores.append(real(*args))
        return scores[-1]

    monkeypatch.setattr(attention_ops, "_scores", recorded)
    out, row_max, row_inv_sum = attention_fwd_stats_plain(tq, tk, tv, tb, 7, heads, rate)
    (s,) = scores
    assert row_max.shape == row_inv_sum.shape == (b, heads, t)
    torch.testing.assert_close(out, attention_plain(tq, tk, tv, tb, 7, heads, rate),
                               atol=ATOL, rtol=RTOL)
    if rate == 0.0:  # the TPU's dropout bits are its own: only rate 0 compares
        with pltpu.force_tpu_interpret_mode():
            want = jax_fused_attention(*map(jnp.asarray, (q, k, v, bias)),
                                       jnp.zeros((1,), jnp.int32), heads, 0.0)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    rebuilt = torch.exp(s - row_max[..., None]) * row_inv_sum[..., None]
    torch.testing.assert_close(rebuilt, torch.softmax(s, dim=-1), atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(row_max, s.amax(dim=-1), atol=0, rtol=0)
    # and the scores are the function's: S = Q K^T / sqrt(dh) + bias per head
    torch.testing.assert_close(s, _probs(tq, tk, tb, heads)[0], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_sweep_on_a_fully_masked_row_matches_autograd(rng, rate):
    """Every key of batch row 0 masked: row_max is exactly -1e9 (the scores
    round to it), P is uniform 1/T, and the sweep's gradients are autograd's
    of `attention_plain`. A log-sum-exp would have lost the 1/T."""
    b, t, d, heads = 4, 9, 16, 2
    q, k, v, dout = (rng.normal(size=(b, t, d)).astype(np.float32) for _ in range(4))
    bias = _keypad_row0_masked(rng, b, t)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tb, tg = torch.as_tensor(bias), torch.as_tensor(dout)
    want = torch.autograd.grad(attention_plain(tq, tk, tv, tb, 3, heads, rate),
                               (tq, tk, tv), tg)
    res = attention_fwd_stats_plain(tq, tk, tv, tb, 3, heads, rate)
    out, row_max, row_inv_sum = res
    assert torch.equal(row_max[0], torch.full((heads, t), -1e9))
    s, _ = _probs(tq.detach(), tk.detach(), tb, heads)
    p_row0 = torch.exp(s[0] - row_max[0, ..., None]) * row_inv_sum[0, ..., None]
    torch.testing.assert_close(p_row0, torch.full((heads, t, t), 1.0 / t), atol=1e-7, rtol=0)
    lse = row_max + torch.log(1.0 / row_inv_sum)  # what the kernels do not store
    assert torch.equal(lse[0], row_max[0])
    got = attention_bwd_plain(tq, tk, tv, tb, *res, tg, 3, heads, rate)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL)
    for g, w in zip(attention_backward(tq, tk, tv, tb, *res, tg, 3, heads, rate), got):
        assert torch.equal(g, w)  # on CPU tensors the wrapper is the plain version


# ---------------------------------------------------------------------------
# 3xTF32: a numpy emulation of the kernels' tensor-core products
# ---------------------------------------------------------------------------

def tf32(x):
    """cvt.rna.tf32.f32: round to 10 explicit mantissa bits, ties away from
    zero (add half of the dropped 13 bits to the bit pattern, then clear them)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def mm_1xtf32(a, b):
    """One TF32 product per element; the exact sum (float64) of the rounded
    operands' products, as the tensor core forms each product exactly."""
    return (tf32(a).astype(np.float64) @ tf32(b).astype(np.float64)).astype(np.float32)


def mm_3xtf32(a, b):
    """hi*hi + hi*lo + lo*hi with hi = tf32(x), lo = tf32(x - hi)."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    f = lambda x: x.astype(np.float64)  # noqa: E731
    return (f(a_hi) @ f(b_hi) + f(a_hi) @ f(b_lo) + f(a_lo) @ f(b_hi)).astype(np.float32)


def _emulated(mm, q, k, v, bias, dout, heads):
    """Forward and one-sweep backward of attention with every product taken
    by `mm` (numpy, per head): (out, dq, dk, dv)."""
    b, t, d = q.shape
    dh = d // heads
    split = lambda x: x.reshape(b, t, heads, dh).transpose(0, 2, 1, 3)  # noqa: E731
    merge = lambda x: x.transpose(0, 2, 1, 3).reshape(b, t, d)  # noqa: E731
    tr = lambda x: x.transpose(0, 1, 3, 2)  # noqa: E731
    scale = np.float32(1.0 / math.sqrt(dh))
    qh, kh, vh, gh = map(split, (q, k, v, dout))
    s = mm(qh, tr(kh)) * scale + bias
    m = s.max(axis=-1, keepdims=True)
    e = np.exp(s - m)
    p = e * (np.float32(1.0) / e.sum(axis=-1, keepdims=True))
    o = mm(p, vh)
    d_row = (gh * o).sum(axis=-1, keepdims=True)
    ds = p * (mm(gh, tr(vh)) - d_row)
    dv = mm(tr(p), gh)
    dq, dk = mm(ds, kh) * scale, mm(tr(ds), qh) * scale
    return merge(o), merge(dq), merge(dk), merge(dv)


def test_3xtf32_products_keep_the_fp32_tolerances(rng):
    """At T=150, dh=16 on seeded unit-normal inputs, attention with every
    product in 3xTF32 stays within the kernels' fp32 tolerances of the fp32
    plain version, forward and backward; with one TF32 product it does not,
    which is why the kernels split each operand."""
    b, t, d, heads = 2, 150, 32, 2
    q, k, v, dout = (rng.normal(size=(b, t, d)).astype(np.float32) for _ in range(4))
    bias = _causal(t)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = attention_plain(tq, tk, tv, torch.as_tensor(bias), 0, heads, 0.0)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(dout))
    want = [out.detach().numpy()] + [g.numpy() for g in grads]

    def within(got):
        return [np.allclose(g, w, atol=tol, rtol=RTOL)
                for g, w, tol in zip(got, want, (ATOL, BWD_ATOL, BWD_ATOL, BWD_ATOL))]

    assert within(_emulated(mm_3xtf32, q, k, v, bias, dout, heads)) == [True] * 4
    assert not any(within(_emulated(mm_1xtf32, q, k, v, bias, dout, heads)))


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # TF32 spacing in [1, 2)
    x = np.array([1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp * 0.49,
                  3.0e-3], np.float32)
    got = tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0 + one_ulp and got[2] == -(1.0 + one_ulp)
    assert got[3] == 1.0
    assert (got.view(np.uint32) & 0x1FFF == 0).all()
    assert abs(got[4] - x[4]) <= x[4] * 2.0 ** -11


# ---------------------------------------------------------------------------
# the packed argument blocks
# ---------------------------------------------------------------------------

def _fields(struct_name, source=HEADER):
    """The fields of a struct in a C source, in order: 'q' for a long long,
    'd' for a double; a field of the header's struct types is expanded."""
    body = re.search(r"struct %s \{(.*?)\};" % struct_name, source.read_text(), re.S).group(1)
    kinds = []
    for line in body.split(";"):
        line = line.strip()
        if not line:
            continue
        if line.startswith(("FwdArgs ", "BwdArgs ")):
            kinds.append(_fields(line.split()[0]))
            continue
        kind = "q" if line.startswith("long long") else "d"
        assert line.startswith(("long long", "double")), line
        kinds += [kind] * len(line.split(","))
    return "".join(kinds)


def _struct_format(kinds):
    """The struct module's format of a run of 'q' and 'd' fields."""
    runs = re.findall(r"q+|d+", kinds)
    return "<" + "".join(f"{len(r)}{r[0]}" if len(r) > 1 else r[0] for r in runs)


@pytest.mark.parametrize("name,pack,source", [
    ("FwdArgs", "_PACK_FWD", "attention_common.cuh"),
    ("BwdArgs", "_PACK_BWD", "attention_common.cuh"),
    ("BwdLongArgs", "_PACK_BWD_LONG", "attention_bwd_long.cu"),
])
def test_packed_arguments_match_the_c_struct(name, pack, source):
    """Each block the wrappers pack has the field types, in the order, of the
    struct its entry point copies it into (the long path's: the one-sweep
    block, then the D_i scratch's address)."""
    kinds = _fields(name, HEADER.parent / source)
    fmt = getattr(attention_ops, pack).__self__.format
    assert fmt == _struct_format(kinds)
    if name != "BwdLongArgs":
        assert kinds == "q" * kinds.count("q") + "d" * kinds.count("d")  # doubles last
    else:
        assert kinds == _fields("BwdArgs") + "q"


def _fake_entry(monkeypatch, code=0):
    """Binds both entry points to a recorder of the packed blocks (the
    kernels need the card); returns the list the blocks land in."""
    seen = []

    def entry(raw):
        seen.append(raw)
        seed_at = struct.unpack_from("<q", raw, 8 * (21 if len(raw) in (208, 216, 224) else 29))[0]
        # the dropout seed lives on the device: read it while the launch holds it
        entry.seeds.append(ctypes.c_longlong.from_address(seed_at).value if seed_at else None)
        return code

    entry.seeds = []
    _fake_entry.seeds = entry.seeds

    monkeypatch.setattr(attention_ops, "_entry", dict.fromkeys(attention_ops._LIBRARIES, entry))
    # the fp32 long forward's scratch: 64 bytes, whatever the shape
    monkeypatch.setattr(attention_ops, "_fwd_long_scratch", {False: lambda raw: 64,
                                                             True: lambda raw: 64})
    monkeypatch.setattr(attention_ops, "_long_max_t", 65535 * 64)
    monkeypatch.setattr(attention_ops, "_fwd_long_max_t", 65535 * 128)
    # the recorder's one-head kernels, alike in both modes
    monkeypatch.setattr(attention_ops, "_fwd_smem", {
        mode: (lambda t, dh: 1000 * t) for mode in attention_ops.MODES})
    monkeypatch.setattr(attention_ops, "_fwd_max_t", {mode: {
        dh: attention_ops.SMEM_LIMIT // 1000 for dh in attention_ops.KERNEL_HEAD_DIMS}
        for mode in attention_ops.MODES})
    monkeypatch.setattr(attention_ops, "_bwd_smem", {
        mode: (lambda t, dh: 2000 * t) for mode in attention_ops.MODES})
    monkeypatch.setattr(attention_ops._build, "raw_stream", lambda index: 77)
    monkeypatch.setattr(attention_ops, "_bwd_fits", {})
    return seen


def test_launch_packs_strided_views_broadcast_bias_and_dropout(monkeypatch):
    """The fields of both blocks, in the C structs' order, for q, k, v as
    column slices of one projection, a [B, 1, 1, T] bias and rate 0.5."""
    seen = _fake_entry(monkeypatch)
    b, t, d, heads = 2, 5, 16, 2
    q, k, v = torch.randn(b, t, 3 * d).split(d, dim=-1)
    bias = torch.zeros(b, 1, 1, t)
    out, row_max, row_inv_sum = attention_ops._launch_forward(q, k, v, bias, 2**32 + 9,
                                                              heads, 0.5, True)
    assert row_max.shape == row_inv_sum.shape == (b, heads, t)
    f = struct.unpack("<24q2d", seen[-1])
    assert f[:7] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), row_max.data_ptr(), row_inv_sum.data_ptr())
    assert f[7:11] == (b, t, d, heads)
    assert f[11:17] == (3 * d * t, 3 * d) * 3  # batch and time strides of q, k, v
    assert f[17:19] == (t, 0)  # the bias broadcasts over queries
    # dropout, threshold, the seed's address, stream; an int seed is written
    # into a one-element int64 tensor, its low 32 bits
    assert (f[19], f[20], f[22]) == (1, keep_threshold(0.5), 77) and f[21] != 0
    assert _fake_entry.seeds[-1] == 9
    assert f[23] == 0  # row_offset: the call's rows are the batch's
    assert f[24:] == (1.0 / math.sqrt(d // heads), 2.0)
    seed_t = torch.tensor([12345], dtype=torch.int64)  # a step's seed: read where it lies
    attention_ops._launch_forward(q, k, v, bias, seed_t, heads, 0.5, False, row_offset=6)
    f = struct.unpack("<24q2d", seen[-1])
    assert f[21] == seed_t.data_ptr() and _fake_entry.seeds[-1] == 12345 and f[23] == 6
    attention_ops._launch_forward(q, k, v, bias[:1, :, :1], 0, heads, 0.0, False)
    f = struct.unpack("<24q2d", seen[-1])
    assert f[5:7] == (0, 0) and f[17:19] == (0, 0) and f[19:22] == (0, 0, 0)
    dout = torch.randn(b, t, d)
    dq, dk, dv = attention_ops._launch_backward(q, k, v, bias, out, row_max, row_inv_sum,
                                                dout, 9, heads, 0.5)
    g = struct.unpack("<32q2d", seen[-1])
    assert g[:11] == tuple(x.data_ptr() for x in (q, k, v, bias, out, dout, row_max,
                                                  row_inv_sum, dq, dk, dv))
    assert g[15:25] == (3 * d * t, 3 * d) * 3 + (d * t, d) * 2
    assert g[25:27] == (t, 0) and (g[27], g[28], g[30]) == (1, keep_threshold(0.5), 77)
    assert _fake_entry.seeds[-1] == 9 and g[31] == 0 and g[32:] == (1.0 / math.sqrt(8), 2.0)


def test_launch_refusals_become_exceptions(monkeypatch):
    q = torch.randn(1, 300, 16)
    bias = torch.zeros(1, 1, 1, 300)
    seen = _fake_entry(monkeypatch, code=-3)  # too long: the message names the largest T
    with pytest.raises(ValueError, match=r"largest T at this head width: 232\)"):
        attention_ops._launch_forward(q, q, q, bias, 0, 2, 0.0, False, path="sweep")
    # the route hands that shape to the long forward, whose refusal names its limit
    with pytest.raises(ValueError, match="attention_fwd_long: T=300 is beyond its limit of "
                                         "T=8388480"):
        attention_ops._launch_forward(q, q, q, bias, 0, 2, 0.0, False)
    # the one-sweep kernel refuses what its shared memory cannot hold; the
    # long path takes it, so only a head width or a T beyond the long
    # path's limit is refused before a backward
    with pytest.raises(ValueError, match=r"largest T at this head width: 116\)"):
        attention_ops._launch_backward(q, q, q, bias, q, *[torch.zeros(1, 2, 300)] * 2, q,
                                       0, 2, 0.0, path="sweep")
    attention_ops._check_backward_fits(300, 8)
    with pytest.raises(ValueError, match="limit of T=4194240"):
        attention_ops._check_backward_fits(65535 * 64 + 1, 8)
    attention_ops._check_backward_fits(300, 12)  # a padded width: template 16
    attention_ops._check_backward_fits(300, 128)
    attention_ops._check_backward_fits(300, 136)  # the long pairs (both modes): template 256
    with pytest.raises(ValueError, match="head widths 1 to 256 .*got dh=264"):
        attention_ops._check_backward_fits(300, 264)
    with pytest.raises(ValueError, match="beyond its limit of T=4194240"):
        attention_ops._launch_backward(q, q, q, bias, q, *[torch.zeros(1, 2, 300)] * 2, q,
                                       0, 2, 0.0, path="long")
    seen = _fake_entry(monkeypatch, code=-1)
    with pytest.raises(ValueError, match="head widths"):
        attention_ops._launch_forward(q, q, q, bias, 0, 2, 0.0, False)
    seen = _fake_entry(monkeypatch, code=719)
    with pytest.raises(RuntimeError, match="cudaError 719"):
        attention_ops._launch_forward(q, q, q, bias, 0, 2, 0.0, False)
    with pytest.raises(TypeError, match="float32"):
        attention_ops._launch_forward(q.double(), q, q, bias, 0, 2, 0.0, False)
    with pytest.raises(ValueError, match="unit stride"):
        attention_ops._launch_forward(q, q, q, bias.transpose(2, 3), 0, 2, 0.0, False)
    assert len(seen) == 1  # the checks refuse before the entry point is called


def test_backward_route_takes_the_long_path_where_the_sweep_does_not_fit(monkeypatch):
    """The one-sweep kernel keeps every shape it fits; the long path takes
    the rest, packs the one-sweep block plus the D_i scratch and counts in
    its own counter."""
    seen = _fake_entry(monkeypatch)  # one-sweep shared memory: 2000 * T bytes
    fits = attention_ops.SMEM_LIMIT // 2000  # 116
    assert attention_ops.backward_route(fits, 8) == "sweep"
    assert attention_ops.backward_route(fits + 1, 8) == "long"
    b, t, d, heads = 2, fits + 1, 16, 2
    q, k, v, g = (torch.randn(b, t, d) for _ in range(4))
    bias = torch.zeros(b, 1, 1, t)
    stats = torch.zeros(b, heads, t)
    sweeps = attention_ops.fused_attention.backward_launches
    longs = attention_ops.fused_attention.long_backward_launches
    dq, dk, dv = attention_ops._launch_backward(q, k, v, bias, q, stats, stats, g, 0, heads, 0.0)
    assert len(seen[-1]) == struct.calcsize("<32q2dq")
    f = struct.unpack("<32q2dq", seen[-1])
    assert f[8:15] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, d, heads)
    assert f[-1] != 0  # the D_i scratch
    assert attention_ops.fused_attention.long_backward_launches == longs + 1
    assert attention_ops.fused_attention.backward_launches == sweeps
    attention_ops._launch_backward(q[:, :fits], k[:, :fits], v[:, :fits], bias[..., :fits],
                                   q[:, :fits], stats[..., :fits], stats[..., :fits],
                                   g[:, :fits], 0, heads, 0.0)
    assert len(seen[-1]) == struct.calcsize("<32q2d")
    assert attention_ops.fused_attention.backward_launches == sweeps + 1
    with pytest.raises(ValueError, match="'sweep' or 'long'"):
        attention_ops._launch_backward(q, k, v, bias, q, stats, stats, g, 0, heads, 0.0,
                                       path="other")


# ---------------------------------------------------------------------------
# the backward's route, and the long path's regime on the CPU
# ---------------------------------------------------------------------------

def _no_binding(monkeypatch):
    def refuse():
        raise AssertionError("the route rule bound the kernels")
    monkeypatch.setattr(attention_ops, "_bind", refuse)


@pytest.mark.parametrize("dh", attention_ops.KERNEL_HEAD_DIMS)
def test_long_faster_is_the_measured_crossover_and_binds_nothing(monkeypatch, dh):
    """`long_faster` is a rule of (T, dh) alone: false below the head width's
    measured crossover, true from it on (never where none was measured),
    in each mode by that mode's table."""
    _no_binding(monkeypatch)
    for mode in attention_ops.MODES:
        start = attention_ops.LONG_FASTER_FROM[mode][dh]
        for t in (1, 20, 150, 200, 256, 300, 368, 600, 4096):
            assert attention_ops.long_faster(t, dh, mode) == (start is not None
                                                              and t >= start), (mode, t)
        if start is not None:
            assert not attention_ops.long_faster(start - 1, dh, mode)
            assert attention_ops.long_faster(start, dh, mode)


@pytest.mark.parametrize("dh", attention_ops.KERNEL_HEAD_DIMS)
def test_backward_route_sends_each_shape_to_the_faster_path(monkeypatch, dh):
    """The one-sweep kernel where it is the faster and holds the shape; the
    long path from the measured crossover on and, whatever the table says,
    at every T beyond the one-sweep kernel's shared memory."""
    _fake_entry(monkeypatch)
    fits = 900  # the recorder's one-sweep kernel holds T <= 900 at every head width
    monkeypatch.setattr(attention_ops, "_bwd_smem", {
        mode: (lambda t, dh: attention_ops.SMEM_LIMIT * t // fits)
        for mode in attention_ops.MODES})
    for mode in attention_ops.MODES:
        start = attention_ops.LONG_FASTER_FROM[mode][dh]
        for t in (1, 37, 150, 200, 256, 300, 368, 400, 600, fits):
            want = "long" if start is not None and t >= start else "sweep"
            assert attention_ops.backward_route(t, dh, mode) == want, (mode, t)
        for t in (fits + 1, 1000, 65535):
            assert attention_ops.backward_route(t, dh, mode) == "long", (mode, t)
    monkeypatch.setattr(attention_ops, "LONG_FASTER_FROM", {"fp32": {dh: None}, "bf16": {}})
    attention_ops._bwd_fits.clear()
    for mode in attention_ops.MODES:
        assert attention_ops.backward_route(fits, dh, mode) == "sweep"
        assert attention_ops.backward_route(fits + 1, dh, mode) == "long"


def test_long_path_packs_rows_that_start_on_16_bytes(monkeypatch):
    """The long path's copies read q, k, v and dout rows in 16-byte chunks:
    a view whose rows do not start on 16 bytes is copied first; aligned
    column slices of one projection are passed as they are."""
    seen = _fake_entry(monkeypatch)
    b, t, d, heads = 2, 9, 16, 2
    qkv = torch.randn(b, t, 3 * d)
    q, k, v = qkv.split(d, dim=-1)
    misaligned = torch.randn(b, t, d + 1)[..., 1:]
    stats = torch.zeros(b, heads, t)
    bias = torch.zeros(b, 1, 1, t)
    for q_in, copied in ((q, False), (misaligned, True)):
        attention_ops._launch_backward(q_in, k, v, bias, q, stats, stats, q, 0, heads, 0.0,
                                       path="long")
        f = struct.unpack("<32q2dq", seen[-1])
        assert (f[0] != q_in.data_ptr()) == copied
        assert f[0] % 16 == 0 and f[15] % 4 == 0 and f[16] % 4 == 0  # q: base, batch, time
        assert f[1:3] == (k.data_ptr(), v.data_ptr()) and f[17:21] == (3 * d * t, 3 * d) * 2


def test_bwd_plain_matches_jax_vjp_in_the_long_path_s_regime(rng):
    """T=400 at dh=32 (beyond the one-sweep kernel's 368): `attention_bwd_plain`,
    the version the long path is held to on the card, against `jax.vjp` of the
    JAX package's Pallas attention in interpret mode, with key padding and
    batch row 0 fully masked."""
    b, t, d, heads = 2, 400, 128, 4
    q, k, v, dout = (rng.normal(size=(b, t, d)).astype(np.float32) for _ in range(4))
    bias = _keypad_row0_masked(rng, b, t)
    seed = jnp.zeros((1,), jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda q, k, v: jax_fused_attention(q, k, v, jnp.asarray(bias), seed, heads, 0.0),
            *map(jnp.asarray, (q, k, v)))
        want = vjp(jnp.asarray(dout))
    tq, tk, tv, tb = map(torch.as_tensor, (q, k, v, bias))
    res = attention_fwd_stats_plain(tq, tk, tv, tb, 0, heads, 0.0)
    got = attention_bwd_plain(tq, tk, tv, tb, *res, torch.as_tensor(dout), 0, heads, 0.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
