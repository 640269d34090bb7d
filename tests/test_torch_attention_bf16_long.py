"""The native bf16 long attention paths' pieces that run without a card.

The kernels (`csrc/attention_fwd_long_bf16.cu`, `csrc/attention_bwd_long_bf16.cu`)
run on the card only (`tests/test_torch_cuda.py` holds them against their
fp64 oracles and plain versions). Here, on the CPU:

* the pack pre-pass's plain version (`pack_bf16_plain`: bf16 rounding into
  the head-major, padded core-matrix layout) and its inverse round-trip to
  `ops/precision.py::bf16_round` and to JAX's own bf16 cast (what the Pallas
  kernel's `mxu_bf16` mode casts inside its body), at every kernel head
  width, with T not a multiple of a stage and the padding zero; the scratch
  a launch allocates holds exactly the packed regions;
* the route tables per mode: the fp32 values as the fp32 sweeps set them,
  and bf16 calls reading the bf16 table;
* `chip_smoke.py::key_chunk`, the rounding point of the bf16 forward
  kernels' fp64 oracle, equals the sources' stage constants;
* the long forward's operands at each template width
  (`bf16_forward_packing`, mirroring the source): the scratch it allocates,
  the argument block its launch passes and the build it calls.
"""

import importlib.util
import re
import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amid_tpu_torch.ops import attention as attention_ops
from amid_tpu_torch.ops.attention import (
    LONG_BF16_PAD_ROWS,
    LONG_BF16_STAGE_KEYS,
    bf16_packed_shape,
    pack_bf16_plain,
    unpack_bf16_plain,
)
from amid_tpu_torch.ops.precision import bf16_round

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "amid_tpu_torch" / "csrc"


@pytest.mark.parametrize("dh", attention_ops.KERNEL_HEAD_DIMS)
def test_pack_round_trips_to_bf16_rounding_with_zero_padding(dh):
    """q, k, v and dO (one draw each, 4 heads, T=150: 2 stages of 64 and a
    partial one, T_pad 256) packed and unpacked equal bf16_round of the
    input and JAX's astype(bfloat16); every padding row and column is zero;
    the layout is core matrices of 8 x 8 in row-block-major order; the
    scratch of a forward (3 operands) and a backward (4 and the rows'
    float4s) holds exactly its regions."""
    rng = np.random.default_rng(dh)
    heads, t, bsz = 4, 150, 2
    tp, dhp = bf16_packed_shape(t, dh)
    assert t % LONG_BF16_STAGE_KEYS and tp == 256 and dhp == max(dh, 16)
    for name in ("q", "k", "v", "dout"):
        x_np = (rng.normal(size=(bsz, t, heads * dh)) * 3).astype(np.float32)
        x = torch.tensor(x_np)
        packed = pack_bf16_plain(x, heads)
        assert packed.dtype is torch.bfloat16
        assert packed.shape == (bsz, heads, tp // 8, dhp // 8, 8, 8), name
        back = unpack_bf16_plain(packed, t, dh)
        assert torch.equal(back, bf16_round(x)), name
        jax_cast = np.asarray(jnp.asarray(x_np).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(back.numpy(), jax_cast)
        # element (r, c) of head h at core matrix (r / 8, c / 8), row r % 8, column c % 8
        flat = packed.reshape(bsz, heads, -1)
        for r, c in ((0, 0), (9, dh - 1), (t - 1, 5), (t - 1, dh - 1)):
            at = ((r // 8) * (dhp // 8) + c // 8) * 64 + (r % 8) * 8 + c % 8
            assert flat[1, 2, at].item() == bf16_round(x[1, r, 2 * dh + c]).item()
        rows = packed.permute(0, 1, 2, 4, 3, 5).reshape(bsz, heads, tp, dhp)
        assert not rows[:, :, t:].any() and not rows[..., dh:].any(), name
    q = torch.zeros(bsz, t, heads * dh)
    keypad, causal = torch.zeros(bsz, 1, 1, t), torch.zeros(1, 1, t, t)
    packed_bytes = bsz * heads * tp * dhp * 2
    assert attention_ops._long_bf16_scratch(q, causal, heads, 3, 0).numel() == 3 * packed_bytes
    assert attention_ops._long_bf16_scratch(q, keypad, heads, 3, 0).numel() == (
        3 * packed_bytes + bsz * tp * 4)
    assert attention_ops._long_bf16_scratch(q, keypad[:1], heads, 4, 16).numel() == (
        4 * packed_bytes + bsz * heads * tp * 16 + tp * 4)
    assert tp % LONG_BF16_PAD_ROWS == 0 and LONG_BF16_PAD_ROWS % LONG_BF16_STAGE_KEYS == 0


def test_route_tables_are_kept_per_mode_and_bf16_calls_read_theirs(monkeypatch):
    """The fp32 tables are the fp32 sweeps' values; each mode's route reads
    its own table (a bf16 crossover moved without moving fp32's), and the
    launches route a bf16 call by the bf16 table."""
    assert attention_ops.LONG_FWD_FASTER_FROM["fp32"] == {16: 300, 32: 300, 128: 40}
    assert attention_ops.LONG_FASTER_FROM["fp32"] == {8: 512, 16: 368, 32: 150, 64: 150,
                                                      128: 48}
    assert set(attention_ops.LONG_FASTER_FROM) == set(attention_ops.MODES)
    assert set(attention_ops.LONG_FASTER_FROM["bf16"]) == set(attention_ops.KERNEL_HEAD_DIMS)
    monkeypatch.setattr(attention_ops, "forward_max_t", lambda dh, mode="fp32": 800)
    monkeypatch.setattr(attention_ops, "sweep_fits", lambda t, dh, mode="fp32": t <= 368)
    monkeypatch.setattr(attention_ops, "LONG_FWD_FASTER_FROM",
                        {"fp32": {32: 300}, "bf16": {32: 150}})
    monkeypatch.setattr(attention_ops, "LONG_FASTER_FROM",
                        {"fp32": {32: 256}, "bf16": {32: 200}})
    assert attention_ops.forward_route(150, 32, "bf16") == "long"
    assert attention_ops.forward_route(150, 32) == attention_ops.forward_route(150, 32, "fp32")
    assert attention_ops.forward_route(150, 32) == "sweep"
    assert attention_ops.backward_route(200, 32, "bf16") == "long"
    assert attention_ops.backward_route(200, 32) == "sweep"
    assert attention_ops.backward_route(256, 32) == "long"

    # the launches ask the route of their own mode
    asked = []
    monkeypatch.setattr(attention_ops, "_entry", dict.fromkeys(attention_ops._LIBRARIES, object()))
    monkeypatch.setattr(attention_ops._build, "raw_stream", lambda index: 0)
    monkeypatch.setattr(attention_ops, "forward_route",
                        lambda t, dh, mode="fp32": asked.append(("fwd", mode)) or "neither")
    monkeypatch.setattr(attention_ops, "backward_route",
                        lambda t, dh, mode="fp32": asked.append(("bwd", mode)) or "neither")
    x = torch.zeros(2, 150, 64)
    stats = torch.zeros(2, 2, 150)
    for bf16 in (False, True):
        with pytest.raises(ValueError, match="'neither'"):
            attention_ops._launch_forward(x, x, x, torch.zeros(2, 1, 1, 150), 0, 2, 0.0, False,
                                          bf16=bf16)
        with pytest.raises(ValueError, match="'neither'"):
            attention_ops._launch_backward(x, x, x, torch.zeros(2, 1, 1, 150), x, stats, stats,
                                           x, 0, 2, 0.0, bf16=bf16)
    assert asked == [("fwd", "fp32"), ("bwd", "fp32"), ("fwd", "bf16"), ("bwd", "bf16")]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _constant(source: str, name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert len(found) == 1, (source, name, found)
    return int(found[0])


def test_key_chunk_is_the_stage_of_each_bf16_forward_kernel():
    """The fp64 oracle of the bf16 forwards rounds exp(S - m) once a key
    chunk: the native one-head bf16 kernel's kChunk, the native long
    forward's kStageKeys (mirrored in ops/attention.py), at every head
    width."""
    cs = _chip_smoke()
    stage = _constant("attention_fwd_long_bf16.cu", "kStageKeys")
    assert stage == LONG_BF16_STAGE_KEYS
    assert _constant("attention_long_bf16.cuh", "kPadRows") == LONG_BF16_PAD_ROWS
    chunk = _constant("attention_fwd_bf16.cu", "kChunk")
    for dh in attention_ops.KERNEL_HEAD_DIMS:
        assert cs.key_chunk("long", dh) == stage, dh
        assert cs.key_chunk("sweep", dh) == chunk, dh


# the bf16 long forward's operands at each template width: (dh, what its
# pre-pass packs, the rows it pads a packed head to); 24 and 100 and 200 are
# padded widths of the template widths 32, 128 and 256
FORWARD_PACKING = [(8, 3, 128), (16, 3, 128), (24, 3, 128), (32, 3, 128), (64, 3, 128),
                   (100, 2, 64), (128, 2, 64), (200, 2, 64), (256, 2, 64)]


@pytest.mark.parametrize("dh,operands,pad_rows", FORWARD_PACKING)
def test_bf16_forward_scratch_holds_what_its_width_packs(dh, operands, pad_rows):
    """Up to template width 64 the forward's pre-pass packs q, k and v to
    128-row blocks; from 128 on k and v alone, to whole 64-key stages (the
    blocks round their Q rows themselves). The scratch holds exactly those
    packed regions and, for a bias that broadcasts over queries, its rows
    padded to the same T_pad."""
    assert attention_ops.bf16_forward_packing(dh) == (operands, pad_rows)
    heads, t, bsz = 2, 150, 3
    q = torch.zeros(bsz, t, heads * dh)
    keypad, causal = torch.zeros(bsz, 1, 1, t), torch.zeros(1, 1, t, t)
    scratch = [attention_ops._long_bf16_forward_scratch(q, bias, heads)
               for bias in (causal, keypad, keypad[:1])]
    tp = -(-t // pad_rows) * pad_rows
    assert tp == (256 if pad_rows == 128 else 192)
    region = bsz * heads * tp * max(attention_ops.long_head_dim(dh), 16) * 2
    assert [x.numel() for x in scratch] == [operands * region, operands * region + bsz * tp * 4,
                                            operands * region + tp * 4]


@pytest.mark.parametrize("dh,operands,pad_rows", FORWARD_PACKING)
def test_bf16_forward_argument_block_names_its_scratch_and_build(monkeypatch, dh, operands,
                                                                 pad_rows):
    """A bf16 long forward launch calls its width's build (the
    `_bf16_dh256` one above 128) once with FwdArgs and then the address of
    the scratch `_long_bf16_forward_scratch` allocated; the launch is
    counted once."""
    calls = []

    def entry(lib):
        def launch(block):
            calls.append((lib, block))
            return 0
        return launch

    monkeypatch.setattr(attention_ops, "_entry", {n: entry(n) for n in attention_ops._LIBRARIES})
    monkeypatch.setattr(attention_ops._build, "raw_stream", lambda index: 0)
    made = []
    scratch_of = attention_ops._long_bf16_forward_scratch
    monkeypatch.setattr(attention_ops, "_long_bf16_forward_scratch",
                        lambda *a: made.append(scratch_of(*a)) or made[-1])
    heads, t, bsz = 2, 37, 3
    x = torch.zeros(bsz, t, heads * dh)
    before = attention_ops.fused_attention.long_forward_bf16_launches
    attention_ops._launch_forward(x, x, x, torch.zeros(bsz, 1, 1, t), 5, heads, 0.1, True,
                                  "long", bf16=True)
    assert attention_ops.fused_attention.long_forward_bf16_launches == before + 1
    (lib, block), = calls
    assert lib == ("attention_fwd_long_bf16_dh256" if dh > 128 else "attention_fwd_long_bf16")
    fields = struct.unpack("<24q2d", block[:-8])
    assert fields[7:11] == (bsz, t, heads * dh, heads)  # B, T, D, H
    scratch, = struct.unpack("<q", block[-8:])
    assert len(block) == struct.calcsize("<24q2d") + 8
    assert scratch == made[0].data_ptr() and made[0].numel() > 0


def test_bf16_forward_packing_mirrors_the_source():
    """`bf16_forward_packing` is the source's `q_inblock`, `packed_operands`
    and `packed_rows`: Q rounded in the block from template width 128 on,
    and then K and V packed alone to whole stages."""
    src = (CSRC / "attention_fwd_long_bf16.cu").read_text()
    assert "constexpr bool q_inblock(int DH) { return DH >= 128; }" in src
    assert "constexpr int packed_operands(int DH) { return q_inblock(DH) ? 2 : 3; }" in src
    assert re.search(r"packed_operands\(DH\) == 3 \? padded_t\(T\)\s*:\s*\(T \+ kStageKeys - 1\) "
                     r"/ kStageKeys \* kStageKeys", src)
    for width in attention_ops.KERNEL_HEAD_DIMS + (256,):
        operands, pad_rows = attention_ops.bf16_forward_packing(width)
        assert operands == (2 if width >= 128 else 3), width
        assert pad_rows == {3: LONG_BF16_PAD_ROWS, 2: LONG_BF16_STAGE_KEYS}[operands]
