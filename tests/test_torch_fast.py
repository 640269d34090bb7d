"""The port's fast loops on the CPU (`TrainConfig.fast_train`, `fast_eval`):
`run_seed` with the device-resident chunk runner and the stacked evaluation
must reproduce the per-step path — the same batch order (one permutation an
epoch, drawn as `BatchIterator.__iter__` draws it), the same
fold_in(ekey, i) keys, the same log-cadence metrics — as the JAX package's
tests/test_fast_train.py and tests/test_fast_eval.py hold its own. On the CPU
the runners run eagerly, the same code the card captures as CUDA graphs
(the replays are card tests, tests/test_torch_cuda.py); here both paths run
the same arithmetic in the same order, so 1e-6 is a bound on nothing but the
metrics' float formatting.

Also the pieces the graphs need, against the JAX package where it has them:
the static-size unique of the lazy step (`jnp.unique(size=, fill_value=)`),
Adam with its step count on the device (optax over several steps) and the
attention dropout mask from a seed held in a tensor."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import optax

from amid_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from amid_tpu_torch.data.loader import BatchIterator
from amid_tpu_torch.models.amid import build_model
from amid_tpu_torch.ops.attention import attention_plain, dropout_keep_mask
from amid_tpu_torch.ops.rng import StepRandom, fold_in
from amid_tpu_torch.train import lazy, loop, steps
from amid_tpu_torch.train.optim import Adam
from test_torch_train import _synth_packed

TOL = 1e-6
BS = 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The runs here are thousands of tiny ops: on one thread they do not
    contend with the other test processes for the cores (the results do
    not depend on it; both sides of every comparison run on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    # 9 train batches at bs 8 (log_every 2 and 4 both leave a tail chunk of
    # one step), 5 val batches, 7 DR batches
    return tuple(_synth_packed(rng, n, 40, 6) for n in (72, 40, 56))


def _cfg(path, fast: bool, is_dr=True, model_kw=None, **kw):
    mcfg = ModelConfig(**{**dict(backbone="sasrec", emb_dim=16, hid_dim=8, seq_len=6,
                                 batch_size=BS, item_length=90, user_length=90,
                                 sasrec_heads=2, is_dr=is_dr, is_itc=True, ts2=0.4),
                          **(model_kw or {})})
    base = dict(epochs=2, lr=1e-3, seeds=1, checkpoint=False, fast_train=fast,
                fast_eval=fast, model_dir=str(path), model=mcfg,
                data=DataConfig(neg_nums=5), log_every=2)
    return TrainConfig(**{**base, **kw})


def _metric_keys(d):
    return [k for k in d if k.startswith(("hit_", "ndcg_", "mrr", "val_"))]


def _train_lines(path):
    """The logged training lines, timestamps dropped."""
    return [line.split("] ", 1)[1] for line in (path / "log0.txt").read_text().splitlines()
            if "] train " in line or "] epoch " in line]


def _run_both(tmp_path, monkeypatch, data, fast_fields=("fast_train", "fast_eval"), **kw):
    """run_seed per step and with the fields of `fast_fields` on; returns both
    results and how often the fast paths ran (chunked phases, stacked
    evaluation passes)."""
    train, val, dr = data
    ran = {"chunks": 0, "scanned_evals": 0}
    chunked, scanned = loop._run_chunked, loop.evaluate_scanned

    def count_chunks(*a, **k):
        ran["chunks"] += 1
        return chunked(*a, **k)

    def count_evals(*a, **k):
        ran["scanned_evals"] += 1
        return scanned(*a, **k)

    monkeypatch.setattr(loop, "_run_chunked", count_chunks)
    monkeypatch.setattr(loop, "evaluate_scanned", count_evals)
    is_dr = kw.get("is_dr", True)
    dr = dr if is_dr else None
    slow_cfg = _cfg(tmp_path / "slow", False, **kw)
    fast_cfg = _cfg(tmp_path / "fast", False, **kw)
    for field in fast_fields:
        setattr(fast_cfg, field, True)
    slow = loop.run_seed(slow_cfg, 0, train, val, dr, device="cpu")
    assert ran == {"chunks": 0, "scanned_evals": 0}
    fast = loop.run_seed(fast_cfg, 0, train, val, dr, device="cpu")
    return slow, fast, ran


@pytest.mark.parametrize("log_every", [2, 4])
@pytest.mark.parametrize("is_dr", [False, True], ids=["base", "dr"])
@pytest.mark.parametrize("lazy_adam", [False, True], ids=["dense", "lazy"])
def test_fast_loops_match_the_per_step_path(tmp_path, monkeypatch, data, log_every,
                                            is_dr, lazy_adam):
    """Both fast loops on: every metric at 1e-6, and the logged running
    means line for line, over 2 epochs of the base and the DR schedule."""
    slow, fast, ran = _run_both(tmp_path, monkeypatch, data, is_dr=is_dr,
                                lazy_table_adam=lazy_adam, log_every=log_every)
    phases = 2 if is_dr else 1  # an epoch: phase A (and B), an evaluation after each
    assert ran == {"chunks": 2 * phases, "scanned_evals": 2 * phases}
    keys = _metric_keys(slow)
    assert keys and set(keys) == set(_metric_keys(fast))
    for k in keys:
        assert fast[k] == pytest.approx(slow[k], abs=TOL), k
    assert _train_lines(tmp_path / "fast") == _train_lines(tmp_path / "slow")


@pytest.mark.parametrize("lazy_adam", [False, True], ids=["dense", "lazy"])
@pytest.mark.parametrize("backbone", ["bert4rec", "gru4rec"])
def test_fast_loops_match_the_per_step_path_for_each_backbone(tmp_path, monkeypatch, data,
                                                              backbone, lazy_adam):
    """BERT4Rec (dropout on: its five sites draw from the step's generators)
    and GRU4Rec, both fast loops on, one epoch of the DR schedule: every
    metric at 1e-6 and the logged running means line for line."""
    slow, fast, ran = _run_both(tmp_path, monkeypatch, data, epochs=1,
                                lazy_table_adam=lazy_adam,
                                model_kw=dict(backbone=backbone, bert_heads=2, bert_ff_dim=32))
    assert ran == {"chunks": 2, "scanned_evals": 2}
    keys = _metric_keys(slow)
    assert keys and set(keys) == set(_metric_keys(fast))
    for k in keys:
        assert fast[k] == pytest.approx(slow[k], abs=TOL), k
    assert _train_lines(tmp_path / "fast") == _train_lines(tmp_path / "slow")


@pytest.mark.parametrize("field", ["fast_train", "fast_eval"])
def test_each_fast_loop_alone_matches_the_per_step_path(tmp_path, monkeypatch, data, field):
    slow, fast, ran = _run_both(tmp_path, monkeypatch, data, fast_fields=(field,))
    assert (ran["chunks"] > 0, ran["scanned_evals"] > 0) == (
        field == "fast_train", field == "fast_eval")
    for k in _metric_keys(slow):
        assert fast[k] == pytest.approx(slow[k], abs=TOL), k


def test_fast_eval_respects_overlap_buckets(tmp_path, monkeypatch, data):
    slow, fast, _ = _run_both(tmp_path, monkeypatch, data, overlap_eval=True)
    bucketed = [k for k in slow if k.endswith(("_ov", "_no"))]
    assert bucketed, "overlap buckets missing from the per-step path's metrics"
    for k in bucketed:
        assert fast[k] == pytest.approx(slow[k], abs=TOL), k


def test_fast_eval_keeps_the_per_batch_pass_without_drop_last(tmp_path, monkeypatch, data):
    """As in the JAX package, the stacked evaluation needs whole batches: with
    eval_batch_drop_last off the pass stays per batch (and takes the tail)."""
    slow, fast, ran = _run_both(tmp_path, monkeypatch, data, eval_batch_drop_last=False)
    assert ran["scanned_evals"] == 0 and ran["chunks"] > 0
    for k in _metric_keys(slow):
        assert fast[k] == pytest.approx(slow[k], abs=TOL), k


def _small_model_and_data(data):
    cfg = _cfg(".", True).model
    model = build_model(cfg, device="cpu", seed=0)
    train, val, _ = data
    return model, train, val


def test_scanned_eval_equals_the_eval_step_batch_by_batch(data):
    model, _, val = _small_model_and_data(data)
    pools, sizes = loop._device_pools(val, "cpu")
    it = BatchIterator(val, BS, shuffle=False)
    nb = len(it)
    idx = np.arange(nb * BS).reshape(nb, BS)
    stacked = {k: torch.as_tensor(v[idx]) for k, v in it.arrays().items()
               if k in loop.STEP_KEYS}
    eval_all = steps.make_scanned_eval(model, 5)
    got = {k: v.clone() for k, v in eval_all(stacked, pools, sizes, 77).items()}
    step = steps.make_eval_step(model, 5)
    for i, batch in enumerate(it):
        want = step(loop._to_device(batch, "cpu"), pools, sizes, fold_in(77, i))
        assert float(got["loss_cls"][i]) == float(want["loss_cls"])
        for k in ("ranks_fixed", "ranks_raw"):
            assert torch.equal(got[k][i], want[k])
    with pytest.raises(ValueError, match="bound to the state, arrays and pools"):
        eval_all(dict(stacked), pools, sizes, 77)  # other objects than the first call's


def test_chunk_runner_steps_like_the_per_step_loop(data):
    """Two chunks of the runner equal the same steps taken one by one: the
    same rows of the permutation, the same keys, the first step's metrics of
    each chunk, the latch over the chunk; parameters bit-equal after."""
    train = data[0]
    models = [_small_model_and_data(data)[0] for _ in range(2)]
    pools, sizes = loop._device_pools(train, "cpu")
    perm = np.random.default_rng(3).permutation(len(train))[:9 * BS].astype(np.int32)
    arrays = loop._resident(train.batch_arrays(), "cpu")

    def make(model):
        tx = Adam(1e-3)
        state = lazy.init_lazy_state(dict(model.named_parameters()), tx)
        return state, lazy.make_lazy_train_step(model, tx, dr_e_w=0.1)

    (s_run, step_run), (s_ref, step_ref) = make(models[0]), make(models[1])
    runner = steps.make_resident_chunk_runner(step_run, BS)
    perm_dev = torch.as_tensor(perm)
    firsts = []
    for start, end in ((0, 4), (4, 9)):
        _, m0, nf = runner(s_run, arrays, perm_dev, pools, sizes, 5,
                           range(100 + start, 100 + end), range(start, end))
        assert float(nf) == 0.0 and "nonfinite" not in m0
        firsts.append(m0)
    batches = {k: v[perm] for k, v in train.batch_arrays().items() if k in loop.STEP_KEYS}
    for i in range(9):
        batch = {k: torch.as_tensor(v[i * BS:(i + 1) * BS]) for k, v in batches.items()}
        _, m = step_ref(s_ref, batch, pools, sizes, fold_in(5, 100 + i))
        if i in (0, 4):
            for k, v in firsts[i // 4].items():
                assert torch.equal(v, m[k]), (i, k)
    for (name, a), b in zip(models[0].named_parameters(), models[1].parameters()):
        assert torch.equal(a, b), name
    assert int(s_run.opt_state.count) == int(s_ref.opt_state.count) == 9
    with pytest.raises(ValueError, match="bound to the state"):
        runner(s_ref, arrays, perm_dev, pools, sizes, 5, range(1), range(1))


# ---------------------------------------------------------------------------
# what the graphs need, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["repeats", "at_v_minus_1", "all_equal", "full_budget"])
def test_unique_padded_equals_jnp_unique(case):
    """`lazy.unique_padded` against `jnp.unique(size=, fill_value=)`, what
    the JAX lazy step calls (amid_tpu/train/lazy.py), on the budget the
    lazy step uses."""
    rng = np.random.default_rng(7)
    v = 200
    budget = lazy._unique_budget(8, 6, 1)  # 1024 for 8 * (1 + 1 + 12) = 112 ids
    n = 112
    ids = {
        "repeats": rng.integers(0, 30, n),
        "at_v_minus_1": np.concatenate([rng.integers(0, v, n - 10), np.full(10, v - 1)]),
        "all_equal": np.full(n, 17),
        "full_budget": rng.permutation(budget),  # as many distinct ids as the budget
    }[case].astype(np.int32)
    if case == "full_budget":
        v = budget + 5
    got = lazy.unique_padded(torch.as_tensor(ids), budget, v)
    want = np.asarray(jnp.unique(jnp.asarray(ids), size=budget, fill_value=v))
    assert got.dtype == torch.int32 and got.shape == (budget,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_unique_padded_keeps_the_first_values_when_the_budget_is_short():
    ids = torch.tensor([9, 3, 3, 7, 1, 9, 5], dtype=torch.int64)
    assert lazy.unique_padded(ids, 3, 99).tolist() == [1, 3, 5]
    assert lazy.unique_padded(ids, 7, 99).tolist() == [1, 3, 5, 7, 9, 99, 99]


def test_adam_with_a_device_count_matches_optax_over_steps():
    """Eight steps of the port's Adam against optax.adam: the count is an
    int32 tensor on the parameters' device that each step increments, the
    bias corrections come from it (float64, then float32), and no host
    number of a step is kept by the next one."""
    rng = np.random.default_rng(1)
    shapes = {"w": (6, 4), "b": (4,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = optax.adam(3e-3)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jparams)
    params = {k: torch.tensor(v) for k, v in p0.items()}
    port = Adam(3e-3)
    state = port.init(params)
    count = state.count
    assert count.dtype == torch.int32 and count.device == params["w"].device
    for _ in range(8):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        port.update_(params, {k: torch.tensor(v) for k, v in g.items()}, state)
    assert state.count is count and int(count) == int(jstate[0].count) == 8
    for k in shapes:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]),
                                   atol=1e-6, rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(state.mu[k].numpy(), np.asarray(jstate[0].mu[k]),
                                   atol=1e-7, rtol=1e-5)
        np.testing.assert_allclose(state.nu[k].numpy(), np.asarray(jstate[0].nu[k]),
                                   atol=1e-9, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 977, 2**31 - 2, 2**32 + 9])
def test_dropout_mask_from_a_tensor_seed_equals_the_int_seed(seed):
    """A step draws its attention seed into a one-element int64 tensor; the
    mask (and so the plain attention) it keys equals the int seed's."""
    t_seed = torch.tensor([seed], dtype=torch.int64)
    for bsz, heads, t in ((2, 3, 5), (4, 8, 20)):
        assert torch.equal(dropout_keep_mask(t_seed, bsz, heads, t, 0.5),
                           dropout_keep_mask(seed, bsz, heads, t, 0.5))
    q, k, v = (torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(i))
               for i in range(3))
    bias = torch.zeros(1, 1, 1, 5)
    assert torch.equal(attention_plain(q, k, v, bias, t_seed, 2, 0.5),
                       attention_plain(q, k, v, bias, seed, 2, 0.5))


def test_step_random_reseeds_and_draws_attention_seeds_on_its_device():
    a, b = StepRandom(11, "cpu"), StepRandom(None, "cpu")
    seeds = [a.attention_seed() for _ in range(3)]
    assert all(s.dtype == torch.int64 and s.shape == (1,) for s in seeds)
    assert len({int(s) for s in seeds}) == 3 and all(0 <= int(s) < 2**31 for s in seeds)
    b.reseed(11)
    assert [int(b.attention_seed()) for _ in range(3)] == [int(s) for s in seeds]
    b.reseed(12)
    assert int(b.attention_seed()) != int(seeds[0])


def test_a_step_without_a_key_runs_on_its_generators_as_seeded(data):
    model, train, _ = _small_model_and_data(data)
    pools, sizes = loop._device_pools(train, "cpu")
    batch = loop._to_device(next(iter(BatchIterator(train, BS, shuffle=False))), "cpu")
    step = steps.make_eval_step(model, 5)
    with pytest.raises(ValueError, match="seeded first"):
        step(batch, pools, sizes, None)
    want = step(batch, pools, sizes, 31)
    step.rng.reseed(31)
    got = step(batch, pools, sizes, None)
    assert torch.equal(got["ranks_raw"], want["ranks_raw"])


def test_epoch_hook_sees_each_evaluation_and_the_state(tmp_path, data):
    """`run_seed(..., epoch_hook=)` as in the JAX package: after the main
    evaluation of each epoch and after the post-phase-B one, with the state
    whose parameters are the model's."""
    train, val, dr = data
    seen = []

    def hook(epoch, state, ev, phase):
        seen.append((epoch, phase, int(state.opt_state.count), ev["mrr_d1"]))
        assert "item_embedding" in state.params

    best = loop.run_seed(_cfg(tmp_path, True), 0, train, val, dr, device="cpu",
                         epoch_hook=hook)
    assert [(e, ph, c) for e, ph, c, _ in seen] == [
        (0, "main", 9), (0, "post_dr", 9), (1, "main", 18), (1, "post_dr", 18)]
    assert best["mrr_d1"] == max(m for *_, m in seen)
