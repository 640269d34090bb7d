"""The port's trainer (amid_tpu_torch.train) against the JAX package's, step
by step on the CPU: the same weights and optimizer state (moved by
amid_tpu_torch.convert), the same batches and the same negatives go through
both; every dropout rate is 0 where the two are compared, because the random
streams cannot match. fp32 on both sides; tolerance atol 1e-5 / rtol 1e-4
(sums in another order; Adam's normalised update keeps a gradient's relative
error)."""

import dataclasses
import re

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
from amid_tpu.train import lazy as jax_lazy
from amid_tpu.train import steps as jax_steps
from amid_tpu_torch import config as port_config
from amid_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from amid_tpu_torch.convert import (
    adam_state_from_optax,
    lazy_state_from_numpy,
    params_from_flax,
)
from amid_tpu_torch.data.packed import pack_rows
from amid_tpu_torch.models.amid import build_model
from amid_tpu_torch.ops.rng import StepRandom, fold_in
from amid_tpu_torch.train import lazy, loop, steps
from amid_tpu_torch.train.optim import Adam

ATOL, RTOL = 1e-5, 1e-4
B, T, D, HEADS, VOCAB = 8, 8, 16, 2, 100  # table of 2 * VOCAB = 200 rows
LR, LR2, DR_E_W = 1e-3, 2e-3, 0.1
MODEL_KW = dict(backbone="sasrec", emb_dim=D, hid_dim=8, seq_len=T, batch_size=B,
                is_itc=True, ts2=0.12, is_dr=True, item_length=VOCAB, user_length=VOCAB,
                sasrec_heads=HEADS, sasrec_dropout=0.0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(rng):
    v = 2 * VOCAB
    return {
        "target": rng.integers(0, v, B).astype(np.int32),
        "seq_d1": rng.integers(0, v, (B, T)).astype(np.int32),
        "seq_d2": rng.integers(0, v, (B, T)).astype(np.int32),
        "domain_id": rng.integers(0, 2, B).astype(np.int32),
        # two holes per row, ascending pool positions, and a sentinel column
        "reject": np.concatenate([np.sort(rng.integers(0, v, (B, 2)), axis=1),
                                  np.full((B, 1), v)], axis=1).astype(np.int32),
        "reject_counts": np.full(B, 2, np.int32),
        "ob_label": rng.integers(0, 2, B).astype(np.int32),
    }


POOLS = np.tile(np.arange(2 * VOCAB, dtype=np.int32)[None], (2, 1))
POOL_SIZES = np.array([2 * VOCAB, 2 * VOCAB], np.int32)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jax_negatives(key, batch, num_neg, n_split):
    """The negatives the JAX step draws from `key`: its first split key
    (n_split = 4 in the dense phase-A step, 2 in the other train steps, 0 in
    the eval step, which samples with the key itself)."""
    k_neg = jax.random.split(key, n_split)[0] if n_split else key
    jb = _jb(batch)
    return np.array(jax_sample_negatives(
        k_neg, jnp.asarray(POOLS), jnp.asarray(POOL_SIZES), jb["domain_id"],
        jb["reject"], num_neg, jb["reject_counts"]))  # a writable copy


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# the other backbones at the same width: BERT4Rec with 2 heads and a narrow
# FFN (its encoder sees 2T with InterComp), GRU4Rec with hidden width D
BACKBONE_KW = {"bert4rec": dict(backbone="bert4rec", bert_heads=HEADS, bert_ff_dim=32,
                                bert_dropout=0.0),
               "gru4rec": dict(backbone="gru4rec")}


def _jax_model(rng, **overrides):
    jcfg = JaxModelConfig(**{**MODEL_KW, **overrides}, kernels="xla")
    jmodel = jax_build_model(jcfg)
    sample = {**_jb(_batch(rng)), "neg_samples": jnp.zeros((B, 1), jnp.int32)}
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "dropout": key}, sample, train=False)["params"]
    return jmodel, params, overrides


@pytest.fixture
def jax_model(rng):
    return _jax_model(rng)[:2]


@pytest.fixture(params=sorted(BACKBONE_KW))
def backbone_model(rng, request):
    """A JAX model of another backbone, its params and the port's overrides."""
    return _jax_model(rng, **BACKBONE_KW[request.param])


def _port_model(params, **overrides):
    model = build_model(ModelConfig(**{**MODEL_KW, **overrides}), device="cpu")
    model.load_state_dict(params_from_flax(_np_tree(params)), strict=True)
    return model


def _optax_parts(opt_state):
    s = opt_state[0]  # (ScaleByAdamState, EmptyState)
    return np.asarray(s.count), _np_tree(s.mu), _np_tree(s.nu)


def _assert_tree_close(got: dict, want_flax_tree, what, with_table=True):
    want = params_from_flax(_np_tree(want_flax_tree), with_table)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g, w = got[k].detach().numpy(), w.numpy()
        if re.fullmatch(r"enc_d[12]\.block\.\d+\.k\.bias", k):
            continue  # BERT4Rec's key bias: the same zero gradient as below
        if k.endswith("in_proj_bias"):
            # The K third of the bias has an analytically zero gradient (a
            # constant added to every key's score leaves the softmax
            # unchanged), so what reaches Adam is rounding noise and its
            # normalised update is lr * noise / |noise|: not comparable.
            g, w = np.delete(g, slice(D, 2 * D)), np.delete(w, slice(D, 2 * D))
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=f"{what}: {k}")


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

def test_adam_matches_optax_with_a_zero_gradient_leaf(rng):
    """Leaf `c` gets no gradient at steps 1 and 3 (None here, zeros for
    optax): its moments still decay and it still moves, unlike
    torch.optim.Adam, which would skip it."""
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 4)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx, jparams = optax.adam(LR), {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jparams)
    params = {k: torch.tensor(v) for k, v in p0.items()}
    port = Adam(LR)
    state = port.init(params)
    for i in range(5):
        g = {k: rng.normal(size=s).astype(np.float32) * 10.0 ** rng.integers(-4, 1)
             for k, s in shapes.items()}
        skip = i in (1, 3)
        jg = {k: jnp.zeros_like(jparams[k]) if (skip and k == "c") else jnp.asarray(v)
              for k, v in g.items()}
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before_c = params["c"].clone()
        port.update_(params, {k: None if (skip and k == "c") else torch.tensor(v)
                              for k, v in g.items()}, state)
        if skip and i > 0:
            assert not torch.equal(params["c"], before_c)  # moved by its decayed mu
    count, mu, nu = _optax_parts(jstate)
    assert state.count == int(count) == 5
    for k in shapes:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]),
                                   atol=1e-6, rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(state.mu[k].numpy(), mu[k], atol=1e-7, rtol=1e-5)
        np.testing.assert_allclose(state.nu[k].numpy(), nu[k], atol=1e-9, rtol=1e-5)


def test_adam_refuses_a_state_of_other_leaves():
    port = Adam(LR)
    state = port.init({"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="different leaves"):
        port.update_({"b": torch.zeros(2)}, {}, state)


# ---------------------------------------------------------------------------
# dense steps
# ---------------------------------------------------------------------------

def test_dense_steps_match_jax_over_three_rounds(rng, jax_model):
    """One JAX round (phase A, phase B) makes non-zero moments; the state is
    converted; three more rounds run in both packages with the same batches
    and negatives. Parameters and both optimizers' moments must agree."""
    _check_dense_rounds(rng, *jax_model, rounds=3)


def test_dense_steps_match_jax_for_each_backbone(rng, backbone_model):
    """BERT4Rec and GRU4Rec: one dense phase-A step and one phase-B step
    from the converted state of a JAX round, as above."""
    _check_dense_rounds(rng, *backbone_model)


def _check_dense_rounds(rng, jmodel, params, overrides=None, rounds=1):
    tx, tx2 = optax.adam(LR), optax.adam(LR2)
    jstate = jax_steps.TrainState(params, tx.init(params), tx2.init(params))
    jstep_a = jax_steps.make_train_step(jmodel, tx, dr_e_w=DR_E_W)
    jstep_b = jax_steps.make_dr_r_step(jmodel, tx2)
    jp, jps = jnp.asarray(POOLS), jnp.asarray(POOL_SIZES)
    for i, jstep in enumerate((jstep_a, jstep_b)):
        jstate, _ = jstep(jstate, _jb(_batch(rng)), jp, jps, jax.random.PRNGKey(100 + i))

    model = _port_model(jstate.params, **(overrides or {}))
    ptx, ptx2 = Adam(LR), Adam(LR2)
    state = steps.TrainState(
        dict(model.named_parameters()),
        adam_state_from_optax(*_optax_parts(jstate.opt_state)),
        adam_state_from_optax(*_optax_parts(jstate.opt_state2)))
    step_a = steps.make_train_step(model, ptx, dr_e_w=DR_E_W)
    step_b = steps.make_dr_r_step(model, ptx2)
    tp, tps = torch.as_tensor(POOLS), torch.as_tensor(POOL_SIZES)
    for r in range(rounds):
        for phase, (jstep, step, n_split) in enumerate(
                ((jstep_a, step_a, 4), (jstep_b, step_b, 2))):
            batch, key = _batch(rng), jax.random.PRNGKey(10 * r + phase)
            neg = _jax_negatives(key, batch, 1, n_split)
            jstate, jm = jstep(jstate, _jb(batch), jp, jps, key)
            state, m = step(state, _tb(batch), tp, tps, 0, neg=neg)
            assert m.keys() == jm.keys()
            for k in jm:
                np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=ATOL, rtol=RTOL,
                                           err_msg=f"round {r} phase {phase} {k}")
    assert model.item_embedding.grad is None  # autograd.grad leaves .grad alone
    _assert_tree_close(state.params, jstate.params, "params")
    for got, want in ((state.opt_state, jstate.opt_state),
                      (state.opt_state2, jstate.opt_state2)):
        count, mu, nu = _optax_parts(want)
        assert got.count == int(count) == rounds + 1
        _assert_tree_close(got.mu, mu, "mu")
        _assert_tree_close(got.nu, nu, "nu")


def test_c2dsr_branch_is_not_ported(rng):
    """The C2DSR phase-A step is built and runs (it was refused until C2DSR
    was ported; its parity with the JAX step is in tests/test_torch_c2dsr.py):
    its metrics add `loss_cl`, all finite."""
    _, params, _ = _jax_model(rng, is_c2dsr=True)
    model = _port_model(params, is_c2dsr=True)
    step = steps.make_train_step(model, Adam(LR), dr_e_w=DR_E_W, c2dsr_w=0.1)
    _, m = step(steps.init_state(model, Adam(LR)), _tb(_batch(rng)), torch.as_tensor(POOLS),
                torch.as_tensor(POOL_SIZES), 0)
    assert set(m) == {"loss", "loss_cls", "loss_dr_e", "loss_cl", "nonfinite"}
    assert float(m["nonfinite"]) == 0.0 and float(m["loss_cl"]) > 0.0


# ---------------------------------------------------------------------------
# lazy steps
# ---------------------------------------------------------------------------

def _lazy_parts(s):
    count, mu, nu = _optax_parts(s.dense_opt)
    return count, mu, nu, np.asarray(s.mu), np.asarray(s.nu), np.asarray(s.count)


def test_lazy_steps_match_jax(rng, jax_model):
    """One lazy step of each phase from a converted, non-zero LazyTableState;
    the JAX side writes back through its Pallas scatter (interpret mode)."""
    _check_lazy_steps(rng, *jax_model)


def test_lazy_steps_match_jax_for_each_backbone(rng, backbone_model):
    """BERT4Rec and GRU4Rec: a lazy phase-A and a lazy phase-B step, as above."""
    _check_lazy_steps(rng, *backbone_model)


def _check_lazy_steps(rng, jmodel, params, overrides=None):
    jp, jps = jnp.asarray(POOLS), jnp.asarray(POOL_SIZES)
    jstate = jax_lazy.init_lazy_state(params, optax.adam(LR), optax.adam(LR2))
    warm_a = jax_lazy.make_lazy_train_step(jmodel, optax.adam(LR), LR, dr_e_w=DR_E_W)
    warm_b = jax_lazy.make_lazy_dr_r_step(jmodel, optax.adam(LR2), LR2)
    for i, jstep in enumerate((warm_a, warm_b)):
        jstate, _ = jstep(jstate, _jb(_batch(rng)), jp, jps, jax.random.PRNGKey(50 + i))

    model = _port_model(jstate.params, **(overrides or {}))
    state = steps.TrainState(
        dict(model.named_parameters()),
        lazy_state_from_numpy(*_lazy_parts(jstate.opt_state)),
        lazy_state_from_numpy(*_lazy_parts(jstate.opt_state2)))
    step_a = lazy.make_lazy_train_step(model, Adam(LR), dr_e_w=DR_E_W)
    step_b = lazy.make_lazy_dr_r_step(model, Adam(LR2))
    jstep_a = jax_lazy.make_lazy_train_step(jmodel, optax.adam(LR), LR, dr_e_w=DR_E_W,
                                            kernels="pallas")
    jstep_b = jax_lazy.make_lazy_dr_r_step(jmodel, optax.adam(LR2), LR2, kernels="pallas")
    tp, tps = torch.as_tensor(POOLS), torch.as_tensor(POOL_SIZES)
    table_ptr = model.item_embedding.data_ptr()
    for phase, (jstep, step) in enumerate(((jstep_a, step_a), (jstep_b, step_b))):
        batch, key = _batch(rng), jax.random.PRNGKey(phase)
        neg = _jax_negatives(key, batch, 1, 2)
        with pltpu.force_tpu_interpret_mode():
            jstate, jm = jstep(jstate, _jb(batch), jp, jps, key)
        state, m = step(state, _tb(batch), tp, tps, 0, neg=neg)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=ATOL, rtol=RTOL,
                                       err_msg=f"phase {phase} {k}")
    # the table was written in place and never took a dense gradient
    assert model.item_embedding.grad is None
    assert model.item_embedding.data_ptr() == table_ptr
    assert state.params["item_embedding"] is model.item_embedding
    _assert_tree_close(state.params, jstate.params, "params")
    for got, want in ((state.opt_state, jstate.opt_state),
                      (state.opt_state2, jstate.opt_state2)):
        count, mu, nu, tmu, tnu, tcount = _lazy_parts(want)
        assert got.count == int(tcount) == 2 and got.dense_opt.count == int(count) == 2
        _assert_tree_close(got.dense_opt.mu, mu, "dense mu", with_table=False)
        _assert_tree_close(got.dense_opt.nu, nu, "dense nu", with_table=False)
        np.testing.assert_allclose(got.mu.numpy(), tmu, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got.nu.numpy(), tnu, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("phase", ["a", "b"])
@pytest.mark.parametrize("fused_scatter", [True, False])
def test_lazy_first_step_equals_dense(rng, jax_model, phase, fused_scatter):
    """From zero moments a lazy step equals a dense Adam step on every
    parameter: touched rows get the identical update, untouched rows do not
    move either way (mirror of tests/test_lazy_adam.py)."""
    _, params = jax_model
    batch, neg = _tb(_batch(rng)), rng.integers(0, 2 * VOCAB, (B, 1)).astype(np.int32)
    tp, tps = torch.as_tensor(POOLS), torch.as_tensor(POOL_SIZES)
    dense_model, lazy_model = _port_model(params), _port_model(params)
    before = lazy_model.item_embedding.detach().clone()
    if phase == "a":
        dense_step = steps.make_train_step(dense_model, Adam(LR), dr_e_w=DR_E_W)
        lazy_step = lazy.make_lazy_train_step(lazy_model, Adam(LR), dr_e_w=DR_E_W,
                                              fused_scatter=fused_scatter)
    else:
        dense_step = steps.make_dr_r_step(dense_model, Adam(LR2))
        lazy_step = lazy.make_lazy_dr_r_step(lazy_model, Adam(LR2),
                                             fused_scatter=fused_scatter)
    dstate = steps.init_state(dense_model, Adam(LR), Adam(LR2))
    lstate = lazy.init_lazy_state(dict(lazy_model.named_parameters()), Adam(LR), Adam(LR2))
    _, md = dense_step(dstate, batch, tp, tps, 0, neg=neg)
    _, ml = lazy_step(lstate, batch, tp, tps, 0, neg=neg)
    for k in md:
        assert abs(float(md[k]) - float(ml[k])) < 1e-6, k
    for (name, pd), pl in zip(dense_model.named_parameters(), lazy_model.parameters()):
        torch.testing.assert_close(pl, pd, rtol=1e-5, atol=1e-7, msg=name)
    touched = torch.cat([batch["target"], torch.as_tensor(neg).reshape(-1),
                         batch["seq_d1"].reshape(-1), batch["seq_d2"].reshape(-1)]).unique()
    moved = (lazy_model.item_embedding.detach() != before).any(dim=1).nonzero().reshape(-1)
    assert 0 < len(moved) and set(moved.tolist()) <= set(touched.tolist())
    this, other = ((lstate.opt_state, lstate.opt_state2) if phase == "a"
                   else (lstate.opt_state2, lstate.opt_state))
    assert (this.count, other.count) == (1, 0)
    assert torch.count_nonzero(other.mu) == 0 and torch.count_nonzero(this.mu) > 0


def test_unique_budget_is_the_jax_package_s():
    for args in ((256, 20, 1), (256, 150, 1), (8, 8, 1), (3, 5, 2)):
        assert lazy._unique_budget(*args) == jax_lazy._unique_budget(*args)
    assert lazy._unique_budget(256, 20, 1) == 11264
    assert lazy._unique_budget(256, 150, 1) == 77824


# ---------------------------------------------------------------------------
# eval step
# ---------------------------------------------------------------------------

def test_eval_step_matches_jax(rng, jax_model):
    _check_eval_step(rng, *jax_model)


def test_eval_step_matches_jax_for_each_backbone(rng, backbone_model):
    _check_eval_step(rng, *backbone_model)


def _check_eval_step(rng, jmodel, params, overrides=None):
    num_neg = 19
    batch, key = _batch(rng), jax.random.PRNGKey(3)
    want = jax_steps.make_eval_step(jmodel, num_neg)(
        params, _jb(batch), jnp.asarray(POOLS), jnp.asarray(POOL_SIZES), key)
    model = _port_model(params, **(overrides or {})).train()  # the step switches to eval
    got = steps.make_eval_step(model, num_neg)(
        _tb(batch), torch.as_tensor(POOLS), torch.as_tensor(POOL_SIZES), 0,
        neg=_jax_negatives(key, batch, num_neg, 0))
    assert not model.training
    np.testing.assert_allclose(float(got["loss_cls"]), float(want["loss_cls"]),
                               atol=ATOL, rtol=RTOL)
    for k in ("ranks_fixed", "ranks_raw"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# randomness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "lazy"])
def test_two_steps_from_one_generator_state_are_bit_equal(rng, jax_model, kind):
    """Dropout 0.5 and the sampler on: the same key and state give bit-equal
    losses and parameters; another key gives other losses. The process-wide
    generator is not read (reseeding it in between changes nothing)."""
    _, params = jax_model
    batch = _tb(_batch(rng))
    tp, tps = torch.as_tensor(POOLS), torch.as_tensor(POOL_SIZES)

    def run(key, global_seed):
        torch.manual_seed(global_seed)
        model = _port_model(params, sasrec_dropout=0.5)
        if kind == "dense":
            state = steps.init_state(model, Adam(LR))
            step = steps.make_train_step(model, Adam(LR), dr_e_w=DR_E_W)
        else:
            state = lazy.init_lazy_state(dict(model.named_parameters()), Adam(LR))
            step = lazy.make_lazy_train_step(model, Adam(LR), dr_e_w=DR_E_W)
        _, m = step(state, batch, tp, tps, key)
        return m, model.state_dict()

    (m1, sd1), (m2, sd2), (m3, _) = run(7, 0), run(7, 123), run(8, 0)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for k in sd1:
        assert torch.equal(sd1[k], sd2[k]), k
    assert not torch.equal(m1["loss"], m3["loss"])
    assert float(m1["nonfinite"]) == 0.0


def test_fold_in_and_step_random_are_pure():
    assert fold_in(3, 5) == fold_in(3, 5) and 0 <= fold_in(3, 5) < 2**63
    keys = {fold_in(k, d) for k in range(20) for d in (0, 1, 2, 10_000, 20_000, 30_000)}
    assert len(keys) == 120
    a, b = StepRandom(11, "cpu"), StepRandom(11, "cpu")
    assert [a.attention_seed() for _ in range(4)] == [b.attention_seed() for _ in range(4)]
    x = torch.ones(64, 64)
    da, db = a.dropout(x, 0.5), b.dropout(x, 0.5)
    assert torch.equal(da, db) and set(da.unique().tolist()) == {0.0, 2.0}
    assert abs(float((da == 0).float().mean()) - 0.5) < 3 * 0.5 / 64


def test_train_mode_forward_without_rng_raises(rng, jax_model):
    model = _port_model(jax_model[1], sasrec_dropout=0.5).train()
    batch = {**_tb(_batch(rng)), "neg_samples": torch.zeros(B, 1, dtype=torch.int32)}
    with pytest.raises(ValueError, match="StepRandom"):
        model(batch)
    model(batch, rng=StepRandom(0, "cpu"))  # with it, the forward runs


def test_nonfinite_flag():
    ok = {"a": torch.tensor(1.0), "b": torch.tensor(0.0)}
    assert float(steps.nonfinite_flag(ok)) == 0.0
    assert float(steps.nonfinite_flag({**ok, "c": torch.tensor(float("nan"))})) == 1.0
    assert float(steps.nonfinite_flag({**ok, "c": torch.tensor(float("inf"))})) == 1.0


# ---------------------------------------------------------------------------
# optimizer-state conversion
# ---------------------------------------------------------------------------

def test_optimizer_state_conversion_raises_on_missing_or_left_over_leaf(jax_model):
    _, params = jax_model
    tx = optax.adam(LR)
    count, mu, nu = _optax_parts(tx.init(params))
    ok = adam_state_from_optax(count, mu, nu)
    assert ok.count == 0 and ok.mu.keys() == params_from_flax(_np_tree(params)).keys()
    broken = {k: v for k, v in mu.items() if k != "predict_ips"}
    with pytest.raises(ValueError, match="lacks leaves"):
        adam_state_from_optax(count, broken, nu)
    with pytest.raises(ValueError, match="no counterpart"):
        adam_state_from_optax(count, {**mu, "mystery": np.zeros(2, np.float32)}, nu)
    dense_mu = {k: v for k, v in mu.items() if k != "item_embedding"}
    table = np.zeros((2 * VOCAB, D), np.float32)
    lz = lazy_state_from_numpy(count, dense_mu, dense_mu, table, table, 3)
    assert lz.count == 3 and "item_embedding" not in lz.dense_opt.mu
    with pytest.raises(ValueError, match="item_embedding"):
        lazy_state_from_numpy(count, mu, mu, table, table, 0)  # table left in the dense tree
    with pytest.raises(ValueError, match="one \\[V, D\\] shape"):
        lazy_state_from_numpy(count, dense_mu, dense_mu, table, table[:5], 0)


# ---------------------------------------------------------------------------
# run_seed
# ---------------------------------------------------------------------------

def _synth_packed(rng, n_rows, n_items, seq_len):
    users, s1, s2, dom = [], [], [], []
    for i in range(n_rows):
        users.append(i)
        dom.append(int(rng.integers(0, 2)))
        s1.append(rng.integers(1, n_items, max(int(rng.integers(0, 5)), 2)).tolist())
        s2.append(rng.integers(n_items, 2 * n_items, max(int(rng.integers(0, 5)), 2)).tolist())
    ob = rng.integers(0, 2, n_rows).tolist()
    return pack_rows(users, s1, s2, dom, ob, seq_len, pad_id=2 * n_items + 1)


def _train_cfg(tmp_path, **kw):
    mcfg = ModelConfig(backbone="sasrec", emb_dim=16, hid_dim=8, seq_len=6, batch_size=16,
                       item_length=90, user_length=90, sasrec_heads=2, is_dr=True,
                       is_itc=True, ts2=0.4)
    base = dict(epochs=1, lr=1e-3, seeds=1, checkpoint=False, fast_train=False,
                fast_eval=False, model_dir=str(tmp_path), model=mcfg,
                data=DataConfig(neg_nums=5), log_every=2)
    return TrainConfig(**{**base, **kw})


METRIC_KEYS = {f"{m}_{k}_{d}" for m in ("hit", "ndcg") for k in (1, 5, 10)
               for d in ("d1", "d2")} | {"mrr_d1", "mrr_d2"}


@pytest.mark.parametrize("lazy_adam", [False, True])
def test_run_seed_one_epoch_on_cpu(tmp_path, lazy_adam):
    """A 1-epoch DR run on synthetic packed data returns the reference's
    metric keys (amid_tpu/train/loop.py::run_seed's contract) and logs both
    phases and both evaluations."""
    rng = np.random.default_rng(0)
    train, val, dr = (_synth_packed(rng, n, 40, 6) for n in (64, 32, 48))
    best = loop.run_seed(
        _train_cfg(tmp_path, lazy_table_adam=lazy_adam, overlap_eval=lazy_adam), 0,
        train, val, dr, device="cpu")
    want = METRIC_KEYS | {"examples_per_s", "start_epoch"}
    if lazy_adam:  # overlap buckets too
        want |= {f"{k}_{o}" for k in METRIC_KEYS for o in ("ov", "no")}
    assert best.keys() == want
    assert all(np.isfinite(v) for v in best.values())
    assert best["examples_per_s"] > 0 and 0 < best["mrr_d1"] <= 1
    logged = (tmp_path / "log0.txt").read_text()
    assert logged.count("train loss:") >= 1 and logged.count("train loss_dr_r:") >= 1
    assert "epoch 0/1 val_loss=" in logged and "epoch 0 (post-DR)" in logged
    agg = loop.aggregate_seeds([best, best], loop.init_logger(str(tmp_path), "log_all.txt"))
    assert agg["mrr_d1"] == {"mean": best["mrr_d1"], "std": 0.0}


@pytest.mark.parametrize("field", ["checkpoint", "resume", "profile_steps"])
def test_run_seed_runs_the_checkpoint_resume_and_profile_fields(tmp_path, field):
    """Each field that asked for an unported part until the checkpoint
    manager and the profiler came, run on the CPU (a DR run, the fast
    loops): `checkpoint` writes step 0 and the payload mode under
    model_dir/checkpoint/seed0; `resume` starts after it; `profile_steps`
    writes a Chrome trace to model_dir/profile."""
    rng = np.random.default_rng(0)
    train, val, dr = (_synth_packed(rng, n, 40, 6) for n in (64, 32, 48))
    kw = dict(fast_train=True, fast_eval=True)
    if field == "profile_steps":
        best = loop.run_seed(_train_cfg(tmp_path, profile_steps=2, **kw), 0, train, val, dr,
                             device="cpu")
        assert len(list((tmp_path / "profile").glob("*.pt.trace.json"))) == 1
        assert "profile trace written to" in (tmp_path / "log0.txt").read_text()
    else:
        best = loop.run_seed(_train_cfg(tmp_path, checkpoint=True, **kw), 0, train, val, dr,
                             device="cpu")
        ckpt = tmp_path / "checkpoint" / "seed0"
        assert sorted(p.name for p in ckpt.iterdir()) == ["0.pt", "payload_mode.txt"]
        assert (ckpt / "payload_mode.txt").read_text() == "full"
    assert best["start_epoch"] == 0.0
    if field == "resume":
        best = loop.run_seed(_train_cfg(tmp_path, checkpoint=True, resume=True, epochs=2, **kw),
                             0, train, val, dr, device="cpu")
        assert best["start_epoch"] == 1.0 and 0.0 < best["mrr_d1"] <= 1.0
        assert (tmp_path / "checkpoint" / "seed0" / "1.pt").exists()


def test_run_seed_without_a_device_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.run_seed(_train_cfg(tmp_path), 0, None, None)


def test_nan_policy_halt_raises(tmp_path):
    log = loop.init_logger(str(tmp_path), "log.txt")
    with pytest.raises(loop.NonFiniteLossError, match="epoch 2 step 7"):
        loop._handle_nan(_train_cfg(tmp_path, nan_policy="halt"), log, None, "state", 2, 7)
    # logs only
    assert loop._handle_nan(_train_cfg(tmp_path, nan_policy="ignore"), log, None, "state",
                            2, 7) == "state"


def test_train_config_defaults_are_the_jax_package_s():
    from amid_tpu import config as jax_config

    for cls in ("DataConfig", "MeshConfig", "TrainConfig"):
        ours = {f.name: f.default for f in dataclasses.fields(getattr(port_config, cls))
                if f.default is not dataclasses.MISSING}
        theirs = {f.name: f.default for f in dataclasses.fields(getattr(jax_config, cls))
                  if f.default is not dataclasses.MISSING}
        assert ours.keys() == theirs.keys(), cls
        differ = {k for k in ours if ours[k] != theirs[k]}
        assert differ <= {"data_root"}, (cls, differ)  # no machine path in the port
    cfg = _train_cfg(".", model=ModelConfig(seq_len=33, item_length=7))
    assert (cfg.data.seq_len, cfg.data.pad_id) == (33, 8)
