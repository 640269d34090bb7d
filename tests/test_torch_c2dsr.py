"""C2DSR and the auxiliary losses of the port (amid_tpu_torch.train.c2dsr,
train.aux_losses, data.sampler.interleave_corr_seq) against the JAX
package's, on the CPU in fp32 at atol 1e-5 / rtol 1e-4: the losses and the
interleave on the same numpy-seeded inputs; a dense C2DSR phase-A step of
each backbone against the JAX step over 3 rounds (dropout off, the JAX
step's negatives and corrupted items fed to both); then the port's own
randomness (the plain draws unchanged by C2DSR, the view passes' shared
dropout), the corrupted items' pool, the trainer and the up-front refusal of
attention the kernels cannot hold."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from amid_tpu.data.sampler import interleave_corr_seq as jax_interleave
from amid_tpu.train import aux_losses as jax_aux
from amid_tpu.train import c2dsr as jax_c2dsr
from amid_tpu.train import steps as jax_steps
from amid_tpu.train.loop import run_seed as jax_run_seed
from amid_tpu_torch.config import ModelConfig, encoder_length
from amid_tpu_torch.convert import adam_state_from_optax
from amid_tpu_torch.data.sampler import interleave_corr_seq
from amid_tpu_torch.models.amid import build_model, check_kernels_fit, head_width
from amid_tpu_torch.ops import attention as attention_ops
from amid_tpu_torch.ops.rng import StepRandom, fold_in
from amid_tpu_torch.train import aux_losses, c2dsr, loop, steps
from amid_tpu_torch.train.optim import Adam
from test_torch_train import (
    ATOL, B, BACKBONE_KW, DR_E_W, LR, MODEL_KW, POOL_SIZES, POOLS, RTOL, T, VOCAB,
    _assert_tree_close, _batch, _jax_model, _jax_negatives, _jb, _optax_parts,
    _port_model, _synth_packed, _tb, _train_cfg,
)

CL_W = 0.1


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=what)


# ---------------------------------------------------------------------------
# the losses and the interleave against the JAX package's
# ---------------------------------------------------------------------------

def test_infomax_loss_numpy_oracle(rng):
    h = [rng.normal(size=(8, 16)).astype(np.float32) for _ in range(6)]
    got = float(c2dsr.infomax_loss(*[torch.tensor(x) for x in h]))
    h1, h2, ha1, ha2, hc1, hc2 = h

    def softplus(x):
        return np.logaddexp(0.0, x)

    want = np.mean(
        softplus(-np.sum(ha1 * h1, -1)) + softplus(-np.sum(ha2 * h2, -1))
        + softplus(np.sum(hc1 * h1, -1)) + softplus(np.sum(hc2 * h2, -1))
    )
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _close(got, jax_c2dsr.infomax_loss(*[jnp.asarray(x) for x in h]))


def test_sce_loss_matches_torch(rng):
    x, y = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(2))
    got = aux_losses.sce_loss(torch.tensor(x), torch.tensor(y), alpha=3)
    _close(got, jax_aux.sce_loss(jnp.asarray(x), jnp.asarray(y), alpha=3))
    # and the reference's F.normalize form (utils.py:170-180)
    tx, ty = (torch.nn.functional.normalize(torch.tensor(a), p=2, dim=-1) for a in (x, y))
    assert abs(float(got) - float(((1 - (tx * ty).sum(-1)) ** 3).mean())) < 1e-6


def test_info_nce_matches_torch(rng):
    a, b = (rng.normal(size=(5, 8)).astype(np.float32) for _ in range(2))
    got = aux_losses.info_nce_loss(torch.tensor(a), torch.tensor(b))
    _close(got, jax_aux.info_nce_loss(jnp.asarray(a), jnp.asarray(b)))
    # a zero row: the norm's eps keeps it finite, as in JAX
    a[0] = 0.0
    _close(aux_losses.info_nce_loss(torch.tensor(a), torch.tensor(b)),
           jax_aux.info_nce_loss(jnp.asarray(a), jnp.asarray(b)))


def test_contrastive_margin_matches_torch(rng):
    x0, x1 = (rng.normal(size=(4, 8)).astype(np.float32) for _ in range(2))
    x1[1] = x0[1] + 0.1  # inside the margin
    y = np.array([1, 0, 1, 0], np.float32)
    got = aux_losses.contrastive_margin_loss(*(torch.tensor(v) for v in (x0, x1, y)))
    _close(got, jax_aux.contrastive_margin_loss(*(jnp.asarray(v) for v in (x0, x1, y))))


def test_cross_feature_cl_loss_matches_jax_with_four_slots(rng):
    """4 slots: each query's keys are its own d2 then the 3 other slots' d1
    and d2, 7 columns; the order sets which column is the positive."""
    f1, f2 = ([rng.normal(size=(6, 8)).astype(np.float32) for _ in range(4)] for _ in range(2))
    got = aux_losses.cross_feature_cl_loss([torch.tensor(x) for x in f1],
                                           [torch.tensor(x) for x in f2])
    want = jax_aux.cross_feature_cl_loss([jnp.asarray(x) for x in f1],
                                         [jnp.asarray(x) for x in f2])
    _close(got, want)
    # swapping two slots' d2 features changes the positives: another value
    swapped = list(f2)
    swapped[0], swapped[1] = f2[1], f2[0]
    other = aux_losses.cross_feature_cl_loss([torch.tensor(x) for x in f1],
                                             [torch.tensor(x) for x in swapped])
    assert abs(float(other) - float(got)) > 1e-3


def test_interleave_corr_seq(rng):
    out = interleave_corr_seq(torch.tensor([[1, 2, 3]]), torch.tensor([[9, 8, 7]]))
    np.testing.assert_array_equal(out.numpy(), [[1, 9, 2, 8, 3, 7]])
    real = rng.integers(0, 100, (4, 6)).astype(np.int32)
    fake = rng.integers(100, 200, (4, 6)).astype(np.int32)
    got = interleave_corr_seq(torch.tensor(real), torch.tensor(fake))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_interleave(jnp.asarray(real), jnp.asarray(fake))))
    batch = {"seq_d1": real, "seq_d2": real + 7}
    views = c2dsr.c2dsr_views({k: torch.tensor(v) for k, v in batch.items()}, torch.tensor(fake))
    want = jax_c2dsr.c2dsr_views({k: jnp.asarray(v) for k, v in batch.items()},
                                 jnp.asarray(fake))
    assert views.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(views[k].numpy(), np.asarray(want[k]), err_msg=k)


# ---------------------------------------------------------------------------
# the dense C2DSR phase-A step against the JAX step
# ---------------------------------------------------------------------------

def _jax_corr(key, batch):
    """The corrupted items the JAX step draws from `key`: its third split key."""
    return np.array(jax_c2dsr.sample_corr(
        jax.random.split(key, 4)[2], jnp.asarray(POOLS), jnp.asarray(POOL_SIZES),
        _jb(batch)))


STEP_CASES = {"sasrec": {}, "sasrec_pairwise": {"comp_broadcast_quirk": False},
              **BACKBONE_KW}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_c2dsr_step_matches_jax_over_three_rounds(rng, case):
    """One JAX phase-A C2DSR step makes non-zero moments; the state is
    converted; three more rounds run in both packages with the same batches,
    negatives and corrupted items. After each round: every metric (loss,
    loss_cls, loss_dr_e, loss_cl, nonfinite), the round's gradient of every
    leaf (from Adam's first moment, g = (mu_t - b1 mu_{t-1}) / (1 - b1), on
    each side), the parameters and both moments."""
    jmodel, params, overrides = _jax_model(rng, **STEP_CASES[case], is_c2dsr=True)
    tx = optax.adam(LR)
    jstep = jax_steps.make_train_step(jmodel, tx, dr_e_w=DR_E_W, c2dsr_w=CL_W)
    jp, jps = jnp.asarray(POOLS), jnp.asarray(POOL_SIZES)
    jstate = jax_steps.TrainState(params, tx.init(params))
    jstate, _ = jstep(jstate, _jb(_batch(rng)), jp, jps, jax.random.PRNGKey(100))

    model = _port_model(jstate.params, **overrides)
    state = steps.TrainState(dict(model.named_parameters()),
                             adam_state_from_optax(*_optax_parts(jstate.opt_state)))
    step = steps.make_train_step(model, Adam(LR), dr_e_w=DR_E_W, c2dsr_w=CL_W)
    tp, tps = torch.as_tensor(POOLS), torch.as_tensor(POOL_SIZES)
    b1 = 0.9
    for r in range(3):
        mu_before = {k: v.clone() for k, v in state.opt_state.mu.items()}
        jmu_before = _optax_parts(jstate.opt_state)[1]
        batch, key = _batch(rng), jax.random.PRNGKey(r)
        neg, corr = _jax_negatives(key, batch, 1, 4), _jax_corr(key, batch)
        jstate, jm = jstep(jstate, _jb(batch), jp, jps, key)
        state, m = step(state, _tb(batch), tp, tps, 0, neg=neg, corr=corr)
        assert m.keys() == jm.keys() and "loss_cl" in m
        for k in jm:
            _close(float(m[k]), float(jm[k]), f"round {r} {k}")
        assert float(m["loss_cl"]) > 0.0
        count, jmu, jnu = _optax_parts(jstate.opt_state)
        assert state.opt_state.count == int(count) == r + 2
        jgrad = jax.tree.map(lambda now, was: (now - b1 * was) / (1 - b1), jmu, jmu_before)
        grad = {k: (state.opt_state.mu[k] - b1 * mu_before[k]) / (1 - b1) for k in mu_before}
        _assert_tree_close(grad, jgrad, f"round {r} gradient")
        _assert_tree_close(state.params, jstate.params, f"round {r} params")
        _assert_tree_close(state.opt_state.mu, jmu, f"round {r} mu")
        _assert_tree_close(state.opt_state.nu, jnu, f"round {r} nu")


def test_c2dsr_branch_adds_the_views_gradient(rng):
    """The views carry gradient: the same step with cl_w = 0 moves the
    encoders differently, and with cl_w on the loss is loss_cls + dr_e_w *
    loss_dr_e + cl_w * loss_cl."""
    _, params = _jax_model(rng, is_c2dsr=True)[:2]
    batch, neg = _tb(_batch(rng)), rng.integers(0, 2 * VOCAB, (B, 1)).astype(np.int32)
    corr = rng.integers(0, 2 * VOCAB, (B, T)).astype(np.int32)
    tp, tps = torch.as_tensor(POOLS), torch.as_tensor(POOL_SIZES)
    moved = {}
    for w in (CL_W, 0.0):
        model = _port_model(params, is_c2dsr=True)
        state = steps.init_state(model, Adam(LR))
        _, m = steps.make_train_step(model, Adam(LR), dr_e_w=DR_E_W, c2dsr_w=w)(
            state, batch, tp, tps, 0, neg=neg, corr=corr)
        assert abs(float(m["loss"]) - float(m["loss_cls"] + DR_E_W * m["loss_dr_e"]
                                           + w * m["loss_cl"])) < 1e-6
        moved[w] = state.opt_state.mu["enc_d1.attn.0.in_proj_weight"].clone()
    assert not torch.equal(moved[CL_W], moved[0.0])


# ---------------------------------------------------------------------------
# randomness
# ---------------------------------------------------------------------------

def test_plain_random_streams_are_unchanged_by_c2dsr(rng):
    """A non-C2DSR step's generators are the sampler (fold_in(key, 0)) and the
    dropout generator (fold_in(key, 1)), as before C2DSR; a C2DSR step keeps
    both seeds and their draws and adds its own streams (fold_in(key, 2) and
    fold_in(key, 3)). With dropout 0.5 and cl_w = 0 a C2DSR step draws the
    non-C2DSR step's negatives and main-forward masks: bit-equal losses and
    parameters."""
    plain, with_c2dsr = StepRandom(7, "cpu"), StepRandom(7, "cpu", c2dsr=True)
    assert len(plain.generators()) == 2 and len(with_c2dsr.generators()) == 5
    for gens in (plain.generators(), with_c2dsr.generators()[:2]):
        for gen, i in zip(gens, (0, 1)):
            want = torch.Generator().manual_seed(fold_in(7, i))
            assert torch.equal(gen.get_state(), want.get_state())
    assert torch.equal(with_c2dsr.corr.get_state(),
                       torch.Generator().manual_seed(fold_in(7, 2)).get_state())

    # one set of weights; the plain model's position table is the first T
    # rows of the C2DSR model's (which covers the 2T views)
    _, params = _jax_model(rng, is_c2dsr=True)[:2]
    long_model = _port_model(params, sasrec_dropout=0.5, is_c2dsr=True)
    short = {k: v[:T] if k.endswith("pos_emb") else v for k, v in long_model.state_dict().items()}
    short_model = build_model(ModelConfig(**{**MODEL_KW, "sasrec_dropout": 0.5}), device="cpu")
    short_model.load_state_dict(short, strict=True)
    batch = _tb(_batch(rng))
    tp, tps = torch.as_tensor(POOLS), torch.as_tensor(POOL_SIZES)
    runs = []
    for model, c2dsr_w in ((short_model, None), (long_model, 0.0)):
        state = steps.init_state(model, Adam(LR))
        _, m = steps.make_train_step(model, Adam(LR), dr_e_w=DR_E_W, c2dsr_w=c2dsr_w)(
            state, batch, tp, tps, 11)
        runs.append((m, {k: v[:T] if k.endswith("pos_emb") else v
                         for k, v in model.state_dict().items()}))
    (m0, sd0), (m1, sd1) = runs
    for k in ("loss_cls", "loss_dr_e", "loss"):
        assert torch.equal(m0[k], m1[k]), k
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k


@pytest.mark.parametrize("backbone", ["sasrec", "bert4rec"])
def test_view_passes_draw_the_same_dropout(rng, backbone):
    """The JAX step gives both view passes one dropout key, so both draw the
    same masks. The port's two view sources, seeded alike, give bit-equal
    train-mode features of one view batch (masks and the attention seeds);
    the main forward's source gives other features; a C2DSR step from one
    key is bit-equal twice."""
    kw = {"sasrec": dict(sasrec_dropout=0.5),
          "bert4rec": {**BACKBONE_KW["bert4rec"], "bert_dropout": 0.5}}[backbone]
    _, params, _ = _jax_model(rng, **{k: v for k, v in kw.items() if "dropout" not in k},
                              is_c2dsr=True)
    model = _port_model(params, **kw, is_c2dsr=True).train()
    batch = _tb(_batch(rng))
    views = c2dsr.c2dsr_views(batch, torch.as_tensor(rng.integers(0, 2 * VOCAB, (B, T))))
    view_batch = {"seq_d1": views["all_seq"], "seq_d2": views["all_seq"]}
    rngs = StepRandom(5, "cpu", c2dsr=True)
    a, b = (model(view_batch, features_only=True, rng=r) for r in rngs.views)
    main = model(view_batch, features_only=True, rng=rngs)
    for x, y, z in zip(a, b, main):
        assert torch.equal(x, y)
        assert not torch.equal(x, z)

    tp, tps = torch.as_tensor(POOLS), torch.as_tensor(POOL_SIZES)
    out = []
    for _ in range(2):
        model = _port_model(params, **kw, is_c2dsr=True)
        state = steps.init_state(model, Adam(LR))
        _, m = steps.make_train_step(model, Adam(LR), dr_e_w=DR_E_W, c2dsr_w=CL_W)(
            state, batch, tp, tps, 9)
        out.append((m, model.state_dict()))
    for k in out[0][0]:
        assert torch.equal(out[0][0][k], out[1][0][k]), k
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


def test_step_losses_is_the_step_s_forward_without_an_update(rng):
    """`step.losses` draws what the step draws from a key (dropout 0.5 on)
    and gives its metrics bit for bit, and moves no parameter."""
    _, params, _ = _jax_model(rng, is_c2dsr=True)
    model = _port_model(params, sasrec_dropout=0.5, is_c2dsr=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _tb(_batch(rng))
    tp, tps = torch.as_tensor(POOLS), torch.as_tensor(POOL_SIZES)
    step = steps.make_train_step(model, Adam(LR), dr_e_w=DR_E_W, c2dsr_w=CL_W)
    with torch.no_grad():
        _, alone = step.losses(batch, tp, tps, 13)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    _, m = step(steps.init_state(model, Adam(LR)), batch, tp, tps, 13)
    assert set(alone) == set(m) - {"nonfinite"}
    for k, v in alone.items():
        assert torch.equal(v, m[k]), k


@pytest.mark.parametrize("with_counts", [True, False])
def test_corrupted_items_avoid_the_user_s_items_and_stay_in_the_active_pool(with_counts):
    """On a packed dataset (real pools and holes): every corrupted item lies
    in the active domain's pool and is none of the user's items of that
    domain, with reject_counts given or derived from the sentinel."""
    data_rng = np.random.default_rng(3)
    ds = _synth_packed(data_rng, 64, 12, 6)
    arrays = ds.batch_arrays()
    batch = {k: torch.as_tensor(arrays[k]) for k in ("seq_d1", "seq_d2", "domain_id", "reject",
                                                      "reject_counts")}
    if not with_counts:
        del batch["reject_counts"]
    pools, sizes = loop._device_pools(ds, "cpu")
    corr = c2dsr.sample_corr(torch.Generator().manual_seed(0), pools, sizes, batch)
    assert corr.shape == (64, 6) and corr.dtype == torch.int32
    seen = set()
    for row in range(64):
        dom = int(batch["domain_id"][row])
        pool = set(ds.pools[dom, :ds.pool_sizes[dom]].tolist())
        held = set(ds.pools[dom][arrays["reject"][row][arrays["reject"][row] < ds.pools.shape[1]]]
                   .tolist())
        got = set(corr[row].tolist())
        assert got <= pool - held, row
        seen |= got
    assert len(seen) > 6  # draws spread over the pools


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backbone,fast", [("sasrec", True), ("sasrec", False),
                                           ("bert4rec", True), ("gru4rec", True)])
def test_c2dsr_training_smoke(tmp_path, backbone, fast):
    """`run_seed` with C2DSR for one epoch of the DR schedule on the CPU, on
    the fast loops and per step: finite metrics in range and loss_cl logged."""
    data_rng = np.random.default_rng(0)
    train, val, dr = (_synth_packed(data_rng, n, 40, 6) for n in (64, 32, 48))
    cfg = _train_cfg(tmp_path, fast_train=fast, fast_eval=fast)
    cfg.model.backbone, cfg.model.is_c2dsr = backbone, True
    best = loop.run_seed(cfg, 0, train, val, dr, device="cpu")
    assert np.isfinite(best["examples_per_s"]) and 0.0 <= best["hit_10_d1"] <= 1.0
    assert all(np.isfinite(v) for v in best.values())
    assert "loss_cl:" in (tmp_path / "log0.txt").read_text()


def test_c2dsr_rejects_lazy(tmp_path):
    """The JAX trainer's ValueError, word for word."""
    cfg = _train_cfg(tmp_path, lazy_table_adam=True)
    cfg.model.is_c2dsr = True
    with pytest.raises(ValueError) as port_err:
        loop.run_seed(cfg, 0, None, None, device="cpu")
    from amid_tpu.config import TrainConfig as JaxTrainConfig

    from amid_tpu.config import ModelConfig as JaxModelConfig

    jcfg = JaxTrainConfig(lazy_table_adam=True, model_dir=str(tmp_path),
                          model=JaxModelConfig(**MODEL_KW, is_c2dsr=True, kernels="xla"))
    with pytest.raises(ValueError) as jax_err:
        jax_run_seed(jcfg, 0, None, None)
    assert str(port_err.value) == str(jax_err.value) == (
        "--isC2DSR is not supported with --lazy_table_adam")


# ---------------------------------------------------------------------------
# the attention lengths and the up-front refusal
# ---------------------------------------------------------------------------

def _fwd_smem(t, dh):
    """`csrc/attention_fwd.cu::smem_bytes`: K and V of one head, T padded to
    a multiple of 8 rows, a row pitch of dh + 4 floats."""
    return 4 * 2 * ((t + 7) & ~7) * (dh + 4)


def _fwd_smem_bf16(t, dh):
    """`csrc/attention_fwd_bf16.cu::smem_bytes`: K and V of one head in
    bf16, T padded to a multiple of 32 rows (the key chunk), a row pitch of
    max(dh, 16) + 8 values."""
    return 2 * 2 * (-(-t // 32) * 32) * (max(dh, 16) + 8)


FWD_SMEM = {"fp32": _fwd_smem, "bf16": _fwd_smem_bf16}


@pytest.fixture
def kernel_limits(monkeypatch):
    """The kernels' limits without the card: the one-head forwards'
    shared-memory functions (fp32 and bf16) and the long paths' longest T
    (the grid's 65,535 blocks of 128 rows)."""
    monkeypatch.setattr(attention_ops, "_entry", dict.fromkeys(attention_ops._LIBRARIES, object()))
    monkeypatch.setattr(attention_ops, "_fwd_smem", dict(FWD_SMEM))
    monkeypatch.setattr(attention_ops, "_fwd_max_t", {
        mode: {dh: attention_ops._largest_t(f, dh) for dh in attention_ops.KERNEL_HEAD_DIMS}
        for mode, f in FWD_SMEM.items()})
    monkeypatch.setattr(attention_ops, "_fwd_long_max_t", 65535 * 128)
    monkeypatch.setattr(attention_ops, "_long_max_t", 65535 * 128)


def test_forward_max_t_is_the_longest_t_in_shared_memory(kernel_limits):
    """Each mode's longest T is its own kernel's: bf16 tiles hold longer
    heads."""
    wants = {"fp32": ((8, 2416), (16, 1448), (32, 800), (64, 424), (128, 216)),
             "bf16": ((8, 2400), (16, 2400), (32, 1440), (64, 800), (128, 416))}
    for mode, pairs in wants.items():
        smem = FWD_SMEM[mode]
        for dh, want in pairs:
            got = attention_ops.forward_max_t(dh, mode)
            assert got == want, (mode, dh)
            assert smem(got, dh) <= attention_ops.SMEM_LIMIT < smem(got + 1, dh)
    assert attention_ops.forward_max_t(16) == attention_ops.forward_max_t(16, "fp32")


BERT_FULL = dict(backbone="bert4rec", emb_dim=128, bert_heads=4, seq_len=150, is_itc=True)


@pytest.mark.parametrize("kw,t,dh", [
    (dict(backbone="sasrec", emb_dim=128, sasrec_heads=8, seq_len=150), 300, 16),
    (dict(backbone="sasrec", emb_dim=128, sasrec_heads=8, seq_len=150, is_inc=True), 600, 16),
    (BERT_FULL, 600, 32),
    ({**BERT_FULL, "is_inc": True}, 1200, 32),
    (dict(backbone="gru4rec", seq_len=150, is_inc=True, is_itc=True), None, None),
])
def test_only_bert4rec_with_both_comps_and_c2dsr_is_refused_at_l150(kernel_limits, kw, t, dh):
    """The C2DSR encoder lengths at amazon's L=150. Only T=1,200 at dh=32 is
    refused by the one-head forward kernel (T<=800): `forward_route` hands it
    to the long forward, and all five configurations pass
    `check_kernels_fit`, with and without C2DSR."""
    cfg = ModelConfig(**kw, is_c2dsr=True)
    assert head_width(cfg) == dh
    check_kernels_fit(cfg)
    check_kernels_fit(ModelConfig(**kw))  # without C2DSR: the encoder at L
    if dh is None:
        return
    assert encoder_length(cfg, 2 * cfg.seq_len) == cfg.enc_seq_len == t
    beyond = t > attention_ops.forward_max_t(dh)
    assert beyond == (t == 1200)
    if beyond:
        assert attention_ops.forward_route(t, dh) == "long"


def test_check_attention_fits_refuses_what_no_kernel_takes(kernel_limits):
    """A head width above the kernels' 256, or a T beyond the long paths'
    limit, is refused before any launch (`check_kernels_fit`), naming the
    backbone, the length, the head width, the limits and the way out."""
    check_kernels_fit(ModelConfig(**{**BERT_FULL, "bert_heads": 1}))  # dh=128 runs
    check_kernels_fit(ModelConfig(**{**BERT_FULL, "emb_dim": 544}))  # dh=136 runs since 256
    with pytest.raises(ValueError) as err:
        check_kernels_fit(ModelConfig(**{**BERT_FULL, "emb_dim": 1056}))
    for part in ("bert4rec", "T=300", "dh=264", "widths 1 to 256", "--kernels torch"):
        assert part in str(err.value), part
    with pytest.raises(ValueError, match=r"T=8388608 at head width dh=32.*T<=8388480"):
        check_kernels_fit(ModelConfig(**{**BERT_FULL, "is_itc": False,
                                         "seq_len": 65536 * 128}))


def test_the_refused_configuration_runs_on_the_cpu_with_plain_kernels(rng):
    """BERT4Rec with InnerComp, InterComp and C2DSR at L=150 (encoder 1,200 on
    the views) trains one phase-A step on the CPU with kernels='torch', at
    the full head width dh=32 and a small batch."""
    cfg = ModelConfig(**BERT_FULL, is_inc=True, is_c2dsr=True, hid_dim=8, batch_size=2,
                      item_length=VOCAB, user_length=VOCAB, bert_ff_dim=64, is_dr=True,
                      kernels="torch")
    model = build_model(cfg, device="cpu")
    gen = np.random.default_rng(1)
    batch = {
        "target": torch.as_tensor(gen.integers(1, 2 * VOCAB, 2), dtype=torch.int32),
        "seq_d1": torch.as_tensor(gen.integers(1, 2 * VOCAB, (2, 150)), dtype=torch.int32),
        "seq_d2": torch.as_tensor(gen.integers(1, 2 * VOCAB, (2, 150)), dtype=torch.int32),
        "domain_id": torch.tensor([0, 1], dtype=torch.int32),
        "reject": torch.tensor([[3, 2 * VOCAB], [5, 2 * VOCAB]], dtype=torch.int32),
    }
    state = steps.init_state(model, Adam(LR))
    _, m = steps.make_train_step(model, Adam(LR), dr_e_w=DR_E_W, c2dsr_w=CL_W)(
        state, batch, torch.as_tensor(POOLS), torch.as_tensor(POOL_SIZES), 3)
    assert float(m["nonfinite"]) == 0.0 and float(m["loss_cl"]) > 0.0
