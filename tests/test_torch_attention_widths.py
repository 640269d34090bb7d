"""K1 at every head width from 1 to 128, on the CPU.

The CUDA kernels take any head width dh up to 128 at a template width (8,
16, 32, 64 or 128; `ops.attention.kernel_head_dim`), and on the card they
are held to the plain versions. Here the plain versions are held to the JAX
package's Pallas kernel in interpret mode (which takes any width: a lane
mask over the full contraction) at widths between the template widths and
at the largest one (dh 4, 12, 24 and 128): the forward, the forward with its
row statistics, the streamed forward at several key tiles and the backward,
fp32 at atol 1e-5 / rtol 1e-4, dropout off; at dh=24 the bf16 plain
versions against the Pallas kernel's `mxu_bf16` mode. Then SASRec and
BERT4Rec at an emb_dim whose head width is padded in the kernels, against
the JAX models (forward and every gradient, weights moved by
`amid_tpu_torch.convert`), and the width rules: the template width, the bf16
long paths' packed width, the long paths' alignment rule, the routes of a
padded width and the refusal of dh above 128."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from amid_tpu.config import ModelConfig as JaxModelConfig
from amid_tpu.models import encoders as jax_encoders
from amid_tpu.models.amid import build_model as jax_build_model
from amid_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from amid_tpu_torch.config import ModelConfig
from amid_tpu_torch.convert import params_from_flax
from amid_tpu_torch.models.amid import build_model, check_kernels_fit, head_width
from amid_tpu_torch.ops import attention as attention_ops
from amid_tpu_torch.ops.attention import (
    attention_bwd_plain,
    attention_fwd_stats_plain,
    attention_fwd_stats_streamed_plain,
    attention_plain,
    bf16_packed_shape,
    kernel_head_dim,
    pack_bf16_plain,
    unpack_bf16_plain,
)
from amid_tpu_torch.ops.precision import bf16_round

ATOL, RTOL = 1e-5, 1e-4  # fp32 on both sides, sums in another order
# the bf16 backward against JAX's, of its largest value: D_i is rowsum(dO o O)
# in the port and rowsum(dP o P) in the JAX kernel, apart by bf16 rounding
# (tests/test_torch_precision.py's BWD_BF16_TOL, measured there at dh=8)
BWD_BF16_TOL = 2e-2
B, T = 2, 19  # T=19: the streamed forward's last key tile is partial
WIDTHS = [(4, 2), (12, 2), (24, 1), (128, 1)]  # (dh, heads): padded widths and the largest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _inputs(rng, d, kind, t=T):
    q, k, v, dout = ((rng.normal(size=(B, t, d))).astype(np.float32) for _ in range(4))
    if kind == "causal":
        bias = np.triu(np.full((t, t), -1e9, np.float32), 1)[None, None]
    else:  # key padding with batch row 0 fully masked
        keep = rng.random((B, t)) < 0.7
        keep[0] = False
        bias = np.where(keep, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    return q, k, v, bias, dout


def _jax_forward_and_grads(q, k, v, bias, dout, heads, mxu_bf16=False):
    """The Pallas kernel's output and `jax.vjp` of it, in interpret mode."""
    seed = jnp.zeros((1,), jnp.int32)
    jbias = jnp.asarray(bias)

    def f(q_, k_, v_):
        return jax_fused_attention(q_, k_, v_, jbias, seed, heads, 0.0, mxu_bf16)

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
        grads = vjp(jnp.asarray(dout))
    return np.asarray(want), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("kind", ["causal", "keypad"])
@pytest.mark.parametrize("dh,heads", WIDTHS)
def test_plain_versions_match_the_pallas_kernel_at_every_width(rng, dh, heads, kind):
    """attention_plain, attention_fwd_stats_plain and the streamed forward
    (key tiles of 4, 8 and 64: partial, several, one) against the Pallas
    kernel; attention_bwd_plain from the forward's residuals, the whole-row
    and the streamed ones, and attention_plain's autograd, against its
    `jax.vjp`; the streamed row statistics equal the whole-row ones."""
    q, k, v, bias, dout = _inputs(rng, dh * heads, kind)
    want, want_grads = _jax_forward_and_grads(q, k, v, bias, dout, heads)
    tq, tk, tv, tbias, tdout = map(torch.as_tensor, (q, k, v, bias, dout))
    res = attention_fwd_stats_plain(tq, tk, tv, tbias, 0, heads, 0.0)
    outs = {"attention_plain": attention_plain(tq, tk, tv, tbias, 0, heads, 0.0),
            "fwd_stats": res[0]}
    for block_k in (4, 8, 64):
        streamed = attention_fwd_stats_streamed_plain(tq, tk, tv, tbias, 0, heads, 0.0, block_k)
        outs[f"streamed_{block_k}"] = streamed[0]
        torch.testing.assert_close(streamed[1], res[1], atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(streamed[2], res[2], atol=1e-7, rtol=1e-6)
    for name, got in outs.items():
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL, err_msg=name)

    auto = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    auto_grads = torch.autograd.grad(attention_plain(*auto, tbias, 0, heads, 0.0), auto, tdout)
    streamed = attention_fwd_stats_streamed_plain(tq, tk, tv, tbias, 0, heads, 0.0, 8)
    for label, grads in (
            ("bwd", attention_bwd_plain(tq, tk, tv, tbias, *res, tdout, 0, heads, 0.0)),
            ("bwd_streamed", attention_bwd_plain(tq, tk, tv, tbias, *streamed, tdout, 0, heads,
                                                 0.0)),
            ("autograd", auto_grads)):
        for name, got, w in zip("qkv", grads, want_grads):
            np.testing.assert_allclose(got.numpy(), w, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{label} d{name}")


@pytest.mark.parametrize("kind", ["causal", "keypad"])
def test_bf16_plain_versions_match_the_pallas_bf16_mode_at_a_padded_width(rng, kind):
    """dh=24 (template 32): the bf16 plain forwards against the Pallas
    kernel's `mxu_bf16=True` at the JAX test's own 1e-5, the bf16 backward
    against its `jax.vjp` at BWD_BF16_TOL of the largest value."""
    heads = 2
    q, k, v, bias, dout = _inputs(rng, 24 * heads, kind)
    want, want_grads = _jax_forward_and_grads(q, k, v, bias, dout, heads, mxu_bf16=True)
    tq, tk, tv, tbias, tdout = map(torch.as_tensor, (q, k, v, bias, dout))
    outs = {
        "attention_plain": attention_plain(tq, tk, tv, tbias, 0, heads, 0.0, True),
        "fwd_stats": attention_fwd_stats_plain(tq, tk, tv, tbias, 0, heads, 0.0, True)[0],
        "streamed": attention_fwd_stats_streamed_plain(tq, tk, tv, tbias, 0, heads, 0.0,
                                                       block_k=8, mxu_bf16=True)[0],
    }
    for name, got in outs.items():
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5, err_msg=name)
    exact = attention_plain(tq, tk, tv, tbias, 0, heads, 0.0).numpy()
    assert np.abs(exact - want).max() > 1e-4  # the mode is on
    res = attention_fwd_stats_plain(tq, tk, tv, tbias, 0, heads, 0.0, True)
    grads = attention_bwd_plain(tq, tk, tv, tbias, *res, tdout, 0, heads, 0.0, True)
    for name, got, w in zip("qkv", grads, want_grads):
        assert np.abs(got.numpy() - w).max() <= BWD_BF16_TOL * np.abs(w).max(), name


# ---------------------------------------------------------------------------
# the models at a padded head width
# ---------------------------------------------------------------------------

MB, VOCAB = 4, 40
MODEL_KW = dict(hid_dim=8, batch_size=MB, is_itc=True, ts2=0.12, is_dr=True,
                item_length=VOCAB, user_length=VOCAB, sasrec_blocks=1, bert_blocks=1,
                bert_ff_dim=32, bert_dropout=0.0)
OUT_KEYS = ("u_d1", "u_d2", "logits_d1", "logits_d2", "ips_d1", "ips_d2", "gfunc_d1",
            "gfunc_d2")


@pytest.mark.parametrize("backbone,emb_dim,dh", [
    ("sasrec", 24, 3),    # 8 heads of 3: template 8
    ("bert4rec", 24, 6),  # 4 heads of 6: template 8, rows not on 16 bytes
    ("sasrec", 96, 12),   # the run.sh model's heads at --emb_dim 96: template 16
])
def test_models_at_a_padded_head_width_match_jax(rng, monkeypatch, backbone, emb_dim, dh):
    """The whole AMIDModel's outputs and the gradient of a weighted sum of
    them with respect to every leaf, against the JAX model sending every
    attention call to its Pallas kernel (interpret mode), key-padding rows
    fully masked included."""
    monkeypatch.setattr(jax_encoders, "PALLAS_ATTN_MIN_T", 1)
    seq_len = 6
    jcfg = JaxModelConfig(**MODEL_KW, backbone=backbone, emb_dim=emb_dim, seq_len=seq_len,
                          kernels="pallas")
    hi = jcfg.item_table_size
    batch = {"seq_d1": rng.integers(1, hi, (MB, seq_len)).astype(np.int32),
             "seq_d2": rng.integers(0, hi, (MB, seq_len)).astype(np.int32),
             "target": rng.integers(0, hi, MB).astype(np.int32),
             "neg_samples": rng.integers(0, hi, (MB, 3)).astype(np.int32)}
    batch["seq_d2"][0] = 0  # BERT4Rec: every key of user 0 masked
    jmodel = jax_build_model(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    weights = {k: rng.normal(size=(MB, 4 if k.startswith(("logits", "ips", "gfunc"))
                                   else emb_dim)).astype(np.float32) for k in OUT_KEYS}

    def jloss(p):
        out = jmodel.apply({"params": p}, jb, train=False)
        return sum(jnp.sum(out[k] * weights[k]) for k in OUT_KEYS), out

    with pltpu.force_tpu_interpret_mode():
        params = jmodel.init({"params": key, "dropout": key}, jb, train=False)["params"]
        (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ModelConfig)
                         if f.name != "kernels"})
    assert head_width(cfg) == dh and kernel_head_dim(dh) != dh
    port = build_model(cfg, device="cpu")
    port.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    out = port(batch)
    for k in OUT_KEYS:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(want[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    loss = sum((out[k] * torch.as_tensor(weights[k])).sum() for k in OUT_KEYS)
    named = list(port.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    want_grads = params_from_flax(jax.tree.map(np.asarray, jgrads))
    assert {n for n, _ in named} == set(want_grads)
    for (name, _), g in zip(named, grads):
        g = torch.zeros_like(want_grads[name]) if g is None else g
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the width rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dh,want", [(1, 8), (3, 8), (8, 8), (9, 16), (12, 16), (20, 32),
                                     (24, 32), (40, 64), (48, 64), (100, 128), (128, 128),
                                     (129, None), (136, None), (0, None)])
def test_kernel_head_dim_is_the_smallest_template_width_that_holds_dh(dh, want):
    assert kernel_head_dim(dh) == want
    assert attention_ops.MAX_HEAD_DIM == attention_ops.KERNEL_HEAD_DIMS[-1] == 128


def test_bf16_packing_at_a_padded_width_fills_whole_k16_steps(rng):
    """dh=24 packs to 32 columns (two k16 steps), dh=6 and dh=12 to 16; the
    padding columns are zero, the real ones bf16_round of the input, and the
    scratch of a launch holds the packed width."""
    for dh, dhp in ((24, 32), (6, 16), (12, 16), (40, 64), (128, 128)):
        assert bf16_packed_shape(150, dh) == (256, dhp)
        assert dhp % 16 == 0
    heads, t = 3, 21
    x = torch.as_tensor((rng.normal(size=(B, t, heads * 24)) * 3).astype(np.float32))
    packed = pack_bf16_plain(x, heads)
    assert packed.shape == (B, heads, 128 // 8, 32 // 8, 8, 8)
    rows = packed.permute(0, 1, 2, 4, 3, 5).reshape(B, heads, 128, 32)
    assert not rows[..., 24:].any() and not rows[:, :, t:].any()
    assert torch.equal(unpack_bf16_plain(packed, t, 24), bf16_round(x))
    q = torch.zeros(B, t, heads * 24)
    causal = torch.zeros(1, 1, t, t)
    assert attention_ops._long_bf16_scratch(q, causal, heads, 3, 0).numel() == (
        3 * B * heads * 128 * 32 * 2)


def test_the_long_paths_copy_only_views_their_16_byte_copies_cannot_read():
    """At a head width that is a multiple of 4 a view whose rows do not start
    on 16 bytes is copied before a long launch; at any other width the
    kernels read 4 bytes at a time and nothing is copied."""
    base = torch.zeros(2, 5, 3 * 24 + 1)
    view = base[..., 1:25]  # rows start 4 bytes past 16
    assert not attention_ops._rows_aligned(view, 12)
    assert attention_ops._rows_aligned(view, 6) and attention_ops._rows_aligned(view, 3)
    assert attention_ops._rows_aligned(torch.zeros(2, 5, 24), 12)


@pytest.fixture
def kernel_limits(monkeypatch):
    """The kernels' limits without the card: the one-head forwards' and the
    one-sweep backwards' shared-memory functions at the template width, in
    each mode, and the long paths' longest T."""
    def fwd_smem(t, dh):
        return 4 * 2 * ((t + 7) & ~7) * (kernel_head_dim(dh) + 4)

    def bwd_smem(t, dh):
        w = kernel_head_dim(dh)
        tq = -(-t // 16) * 16
        return 4 * ((4 if w < 64 else 5) * tq * (w + 4) + 4 * tq + 8 * 16 * 20)

    def fwd_smem_bf16(t, dh):  # bf16 rows of max(dh, 16) + 8 values, T to 32 keys
        return 2 * 2 * (-(-t // 32) * 32) * (max(kernel_head_dim(dh), 16) + 8)

    def bwd_smem_bf16(t, dh):  # Q, dO, K (and V at 128) in bf16, dQ in fp32, 4 rows
        w = max(kernel_head_dim(dh), 16)
        tq = -(-t // 16) * 16
        return (4 if w > 64 else 3) * tq * (w + 8) * 2 + tq * (w + 8) * 4 + 16 * tq

    fwd = {"fp32": fwd_smem, "bf16": fwd_smem_bf16}
    monkeypatch.setattr(attention_ops, "_entry", dict.fromkeys(attention_ops._LIBRARIES, object()))
    monkeypatch.setattr(attention_ops, "_fwd_smem", fwd)
    monkeypatch.setattr(attention_ops, "_bwd_smem", {"fp32": bwd_smem, "bf16": bwd_smem_bf16})
    monkeypatch.setattr(attention_ops, "_bwd_fits", {})
    monkeypatch.setattr(attention_ops, "_fwd_max_t", {mode: {
        w: attention_ops._largest_t(f, w) for w in attention_ops.KERNEL_HEAD_DIMS}
        for mode, f in fwd.items()})
    monkeypatch.setattr(attention_ops, "_fwd_long_max_t", 65535 * 128)
    monkeypatch.setattr(attention_ops, "_long_max_t", 65535 * 128)


@pytest.mark.parametrize("dh", [3, 6, 12, 20, 24, 40, 48, 100])
def test_a_padded_width_routes_as_its_template_width(kernel_limits, dh):
    """The one-head forward's limit, both routes and both modes' tables read
    the template width's entries."""
    w = kernel_head_dim(dh)
    for mode in attention_ops.MODES:
        assert attention_ops.forward_max_t(dh, mode) == attention_ops.forward_max_t(w, mode) > 0
        for t in (1, 20, 80, 150, 200, 300, 512, 1200):
            assert attention_ops.forward_route(t, dh, mode) == attention_ops.forward_route(
                t, w, mode), (mode, t)
            assert attention_ops.backward_route(t, dh, mode) == attention_ops.backward_route(
                t, w, mode), (mode, t)


@pytest.mark.parametrize("bf16", [False, True])
def test_check_attention_fits_takes_every_width_up_to_128(kernel_limits, bf16):
    """dh=12 (SASRec at --emb_dim 96) and dh=128 (BERT4Rec at --emb_dim 512)
    pass `check_kernels_fit`; since the long paths take template width 256
    in both modes, so do dh=136 and dh=256 (BERT4Rec at --emb_dim 1024,
    configurations (c) and (d)). Each refusal comes before any launch,
    naming the width, the limit and --kernels torch: above 256, in either
    mode."""
    sasrec = ModelConfig(backbone="sasrec", emb_dim=96, seq_len=150, use_bf16=bf16)
    bert = ModelConfig(backbone="bert4rec", emb_dim=512, seq_len=150, is_itc=True,
                       use_bf16=bf16)
    assert (head_width(sasrec), head_width(bert)) == (12, 128)
    check_kernels_fit(sasrec)
    check_kernels_fit(bert)
    widest = 256
    for dh in (136, widest):  # a padded width of template 256, and the widest head
        check_kernels_fit(dataclasses.replace(bert, emb_dim=4 * dh))
    over = dataclasses.replace(bert, emb_dim=4 * (widest + 8))
    with pytest.raises(ValueError) as err:
        check_kernels_fit(over)
    for part in (f"dh={widest + 8}", f"head widths 1 to {widest} (fp32 and bf16)",
                 "--kernels torch"):
        assert part in str(err.value), part
    with pytest.raises(ValueError, match=f"got dh={widest + 8}"):
        attention_ops._check_backward_fits(150, widest + 8)
    attention_ops._check_backward_fits(150, widest)


def test_a_padded_width_takes_the_padded_build_of_the_fp32_long_paths(monkeypatch):
    """The fp32 long paths have a build for padded widths (dh read at run
    time) beside the one whose instances take their template width as a
    constant: a launch at dh=12 calls the former's entry points, at dh=16
    the latter's, each once."""
    calls = []

    def entry(name):
        def launch(block):
            calls.append(name)
            return 0
        return launch

    monkeypatch.setattr(attention_ops, "_entry", {
        "attention_fwd_long": entry("fwd"), "attention_bwd_long": entry("bwd"),
        "attention_fwd_long_pad": entry("fwd_pad"), "attention_bwd_long_pad": entry("bwd_pad")})
    monkeypatch.setattr(attention_ops, "_fwd_long_scratch", {False: lambda raw: 16,
                                                             True: lambda raw: 16})
    monkeypatch.setattr(attention_ops._build, "raw_stream", lambda index: 0)
    heads, t = 2, 9
    for dh in (12, 16):
        x = torch.zeros(B, t, dh * heads)
        stats, bias = torch.zeros(B, heads, t), torch.zeros(B, 1, 1, t)
        attention_ops._launch_forward(x, x, x, bias, 0, heads, 0.0, False, "long")
        attention_ops._launch_backward(x, x, x, bias, x, stats, stats, x, 0, heads, 0.0, "long")
    assert calls == ["fwd_pad", "bwd_pad", "fwd", "bwd"]
