"""The native bf16 one-head attention pair's pieces that run without a card.

The kernels (`csrc/attention_fwd_bf16.cu`, `csrc/attention_bwd_bf16.cu`)
run on the card only (`tests/test_torch_cuda.py` and `chip_smoke.py` hold
them against their fp64 oracles and plain versions). Here, on the CPU:

* `chip_smoke.py::bf16_attention_kernel_oracle` at the one-head kernel's key
  chunk (the forward kernel's own rounding points in fp64: bf16 operands,
  the unnormalised exp(S - m) rounded once a chunk) against the plain bf16
  forward (`attention_fwd_stats_plain(..., mxu_bf16=True)`, which rounds the
  normalised P as the JAX kernel does) within the case's `BF16_LIMITS`
  kernel_plain limit, with the fp32 plain forward outside the kernel_oracle
  limit as the control: dh 16 and 12 (configuration (b)'s, padded to 16),
  causal and key padding (batch row 0 fully masked), rates 0 and 0.5, T of
  20 and 37 (not a multiple of the chunk);
* the pair are sources of their own, not builds of the fp32 sources with a
  define: no `AMID_ATTN_BF16` is left in the port, each source names the
  Pallas kernel it replaces and issues bf16 `mma.sync` products only;
* the routes and the refusals of the bf16 mode read the bf16 kernels' own
  shared-memory limits (`forward_max_t`, `sweep_fits`).
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from amid_tpu_torch.ops import _build
from amid_tpu_torch.ops import attention as attention_ops
from amid_tpu_torch.ops.attention import attention_fwd_stats_plain

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "amid_tpu_torch" / "csrc"
B, HEADS = 3, 2  # small: the oracle runs in fp64 on the CPU


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


def _bias(rng, kind, t):
    if kind == "causal":
        return torch.triu(torch.full((t, t), -1e9), diagonal=1)[None, None]
    lens = rng.integers(1, t + 1, B)
    key_ok = np.arange(t)[None, :] >= (t - lens[:, None])
    key_ok[0] = False  # a fully masked row: m = -1e9, P = 1/T
    return torch.tensor(np.where(key_ok, 0.0, -1e9).astype(np.float32))[:, None, None, :]


@pytest.mark.parametrize("t", [20, 37])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("kind", ["causal", "keypad"])
@pytest.mark.parametrize("dh", [16, 12])
def test_kernel_oracle_at_the_one_head_chunk_against_the_plain_bf16_forward(dh, kind, rate,
                                                                            t):
    """The oracle of the kernel's rounding points and the plain bf16 forward
    are one bf16 rounding apart (the kernel_plain limit of the T=20 or
    T=150 case at this rate); the fp32 forward is not within the oracle's
    kernel_oracle limit of it, so the oracle can tell the bf16 kernel from
    the fp32 one."""
    rng = np.random.default_rng(1000 * dh + 10 * t + int(rate * 2) + (kind == "keypad"))
    q, k, v = (torch.tensor(rng.normal(size=(B, t, dh * HEADS)).astype(np.float32))
               for _ in range(3))
    bias = _bias(rng, kind, t)
    seed = 77
    chunk = CS.key_chunk("sweep", dh)
    oracle = CS.bf16_attention_kernel_oracle(torch, q, k, v, bias, seed, HEADS, rate, chunk)
    plain = attention_fwd_stats_plain(q, k, v, bias, seed, HEADS, rate, True)[0]
    fp32 = attention_fwd_stats_plain(q, k, v, bias, seed, HEADS, rate, False)[0]
    limits = CS.BF16_LIMITS[f"bf16_causal_T{20 if t <= 20 else 150}_h8_rate{rate}"]
    assert torch.isfinite(oracle).all()
    assert oracle.shape == plain.shape == (B, t, dh * HEADS)
    apart = CS.rel_norm(oracle, plain)
    assert 0.0 < apart <= limits[1], apart
    control = CS.rel_norm(fp32, oracle)
    assert control > limits[0], control


def test_the_bf16_one_head_pair_are_sources_of_their_own():
    """`attention_fwd_bf16` and `attention_bwd_bf16` compile their own
    sources with no define; no `AMID_ATTN_BF16` is left in the port; each
    header names the Pallas kernel it replaces; the products are bf16
    `mma.sync` (m16n8k16) and no TF32 one."""
    for name, pallas in (("attention_fwd_bf16", "_fwd_kernel"),
                         ("attention_bwd_bf16", "_bwd_kernel")):
        assert name not in _build.VARIANTS
        assert name in attention_ops._LIBRARIES
        assert _build._source(name) == (CSRC / f"{name}.cu", ())
        text = (CSRC / f"{name}.cu").read_text()
        header = text[:text.index("#include")]
        assert f"Replaces amid_tpu/ops/pallas_attention.py::{pallas} with mxu_bf16=True" in (
            " ".join(header.replace("//", " ").split()))
        assert "mma_bf16(" in text and "ldsm_x4" in text
        for tf32 in ("mma_tf32", "mma3(", "split_a(", "tf32"):
            assert tf32 not in text, (name, tf32)
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in (
        CSRC / "attention_common.cuh").read_text()
    # the variants: the fp32 long paths' padded builds and the bf16 long
    # paths' template width 256; none of the one-head pair's sources
    assert all(n.endswith(("_pad", "_bf16_dh256")) for n in _build.VARIANTS)
    assert not {"attention_fwd_bf16", "attention_bwd_bf16"} & {
        src for src, _ in _build.VARIANTS.values()}
    port = ROOT / "amid_tpu_torch"
    for path in [*port.rglob("*.py"), *port.rglob("*.cu"), *port.rglob("*.cuh")]:
        assert "AMID_ATTN_BF16" not in path.read_text(), path
        assert not re.search(r"\bkBf16\b", path.read_text()), path


@pytest.fixture
def mode_limits(monkeypatch):
    """Recorder kernels whose bf16 builds hold twice the T of the fp32 ones
    (the fp32 forward 1,000 bytes a key, the backward 2,000; bf16 half)."""
    fwd = {"fp32": lambda t, dh: 1000 * t, "bf16": lambda t, dh: 500 * t}
    monkeypatch.setattr(attention_ops, "_entry", dict.fromkeys(attention_ops._LIBRARIES, object()))
    monkeypatch.setattr(attention_ops, "_fwd_smem", fwd)
    monkeypatch.setattr(attention_ops, "_fwd_max_t", {mode: {
        dh: attention_ops._largest_t(f, dh) for dh in attention_ops.KERNEL_HEAD_DIMS}
        for mode, f in fwd.items()})
    monkeypatch.setattr(attention_ops, "_bwd_smem", {"fp32": lambda t, dh: 2000 * t,
                                                     "bf16": lambda t, dh: 1000 * t})
    monkeypatch.setattr(attention_ops, "_bwd_fits", {})
    monkeypatch.setattr(attention_ops, "LONG_FWD_FASTER_FROM", {"fp32": {}, "bf16": {}})
    monkeypatch.setattr(attention_ops, "LONG_FASTER_FROM", {"fp32": {}, "bf16": {}})
    monkeypatch.setattr(attention_ops._build, "raw_stream", lambda index: 0)
    return attention_ops.SMEM_LIMIT


def test_each_mode_routes_by_its_own_kernels_limits(mode_limits):
    """The one-head forward and the one-sweep backward keep every T their
    mode's kernel holds; one T more goes to the long path. Each mode's
    answer is asked and kept apart."""
    limit = mode_limits
    for mode, fwd_bytes, bwd_bytes in (("fp32", 1000, 2000), ("bf16", 500, 1000)):
        t_fwd, t_bwd = limit // fwd_bytes, limit // bwd_bytes
        assert attention_ops.forward_max_t(16, mode) == t_fwd
        assert attention_ops.forward_route(t_fwd, 16, mode) == "sweep"
        assert attention_ops.forward_route(t_fwd + 1, 16, mode) == "long"
        assert attention_ops.sweep_fits(t_bwd, 16, mode)
        assert not attention_ops.sweep_fits(t_bwd + 1, 16, mode)
        assert attention_ops.backward_route(t_bwd, 16, mode) == "sweep"
        assert attention_ops.backward_route(t_bwd + 1, 16, mode) == "long"
    # an fp32 shape the bf16 kernel holds: apart in the cache, apart in the route
    t = limit // 2000 + 1
    assert not attention_ops.sweep_fits(t, 16) and attention_ops.sweep_fits(t, 16, "bf16")
    assert attention_ops._bwd_fits[(t, 16, "fp32")] is False
    assert attention_ops._bwd_fits[(t, 16, "bf16")] is True
    assert attention_ops.forward_max_t(16) == attention_ops.forward_max_t(16, "fp32")


def test_a_refused_bf16_launch_names_the_bf16_kernels_limit(mode_limits, monkeypatch):
    """A one-head bf16 launch the kernel refuses as too long reports the
    bf16 kernel's longest T, not the fp32 one's."""
    refused = lambda block: -3  # noqa: E731 (kTooLong)
    monkeypatch.setattr(attention_ops, "_entry", {"attention_fwd_bf16": refused,
                                                  "attention_bwd_bf16": refused})
    t, d, heads = 8, 32, 2
    x = torch.zeros(1, t, d)
    bias = torch.zeros(1, 1, 1, t)
    with pytest.raises(ValueError, match=f"largest T at this head width: "
                                         f"{mode_limits // 500}\\)"):
        attention_ops._launch_forward(x, x, x, bias, 0, heads, 0.0, False, "sweep", bf16=True)
    stats = torch.zeros(1, heads, t)
    with pytest.raises(ValueError, match=f"largest T at this head width: "
                                         f"{mode_limits // 1000}\\)"):
        attention_ops._launch_backward(x, x, x, bias, x, stats, stats, x, 0, heads, 0.0,
                                       "sweep", bf16=True)
