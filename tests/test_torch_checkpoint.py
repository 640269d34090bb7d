"""The port's checkpoint manager (`amid_tpu_torch/train/checkpoint.py`),
resume and the roll-back on a non-finite loss, against the JAX package's, on
the CPU at tiny shapes: one state built in both packages from the same numpy
arrays is saved and restored by each, and the restored leaves are compared
bit for bit (the bf16 round trip included: torch and `jnp` both round to
nearest even); `run_seed` of both packages resumes and rolls back alike.

One difference is deliberate: the port's `restore` writes into the state's
own tensors and returns that same object (the fast loops' CUDA graphs read
those tensors), where the JAX package returns a new tree."""

import logging

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from amid_tpu import config as jax_config
from amid_tpu.data.packed import pack_rows as jax_pack_rows
from amid_tpu.train import lazy as jax_lazy
from amid_tpu.train import loop as jax_loop
from amid_tpu.train import steps as jax_steps
from amid_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from amid_tpu_torch import config
from amid_tpu_torch.data.packed import pack_rows
from amid_tpu_torch.train import loop
from amid_tpu_torch.train.checkpoint import PAYLOADS, CheckpointManager, state_leaves
from amid_tpu_torch.train.lazy import LazyTableState
from amid_tpu_torch.train.optim import AdamState
from amid_tpu_torch.train.steps import TrainState

V, D = 16, 4


def _arrays(rng, lazy):
    """Every leaf of a state as numpy arrays, by the port's flat names:
    non-zero moments and counts; the lazy state with its DR slot."""
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    out = {"params/w": f32(D, D), "params/b": f32(D)}
    if not lazy:
        return {**out, "opt_state/count": np.int32(5),
                **{f"opt_state/{m}/{k}": f32(*out[f"params/{k}"].shape)
                   for m in ("mu", "nu") for k in ("w", "b")}}
    out["params/item_embedding"] = f32(V, D)
    for slot, count in (("opt_state", 7), ("opt_state2", 3)):
        out[f"{slot}/dense_opt/count"] = np.int32(count + 1)
        for m in ("mu", "nu"):
            out[f"{slot}/dense_opt/{m}/w"] = f32(D, D)
            out[f"{slot}/dense_opt/{m}/b"] = f32(D)
            out[f"{slot}/{m}"] = f32(V, D)
        out[f"{slot}/count"] = np.int32(count)
    return out


def _params(a):
    return [k.split("/")[1] for k in a if k.startswith("params/")]


def _port_state(a, lazy):
    t = {k: torch.tensor(v) for k, v in a.items()}
    params = {k: t[f"params/{k}"] for k in _params(a)}
    dense = [k for k in params if k != "item_embedding"]

    def adam(prefix):
        return AdamState(t[f"{prefix}/count"], {k: t[f"{prefix}/mu/{k}"] for k in dense},
                         {k: t[f"{prefix}/nu/{k}"] for k in dense})

    if not lazy:
        return TrainState(params, adam("opt_state"))
    slot = lambda s: LazyTableState(adam(f"{s}/dense_opt"), t[f"{s}/mu"],  # noqa: E731
                                    t[f"{s}/nu"], t[f"{s}/count"])
    return TrainState(params, slot("opt_state"), slot("opt_state2"))


def _jax_state(a, lazy):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    params = {k: j[f"params/{k}"] for k in _params(a)}
    dense = {k: v for k, v in params.items() if k != "item_embedding"}

    def adam(prefix, tree):
        inner, *rest = optax.adam(1e-3).init(tree)
        inner = inner._replace(count=j[f"{prefix}/count"],
                               mu={k: j[f"{prefix}/mu/{k}"] for k in tree},
                               nu={k: j[f"{prefix}/nu/{k}"] for k in tree})
        return (inner, *rest)

    if not lazy:
        return jax_steps.TrainState(params, adam("opt_state", params), None)
    slot = lambda s: jax_lazy.LazyTableState(  # noqa: E731
        adam(f"{s}/dense_opt", dense), j[f"{s}/mu"], j[f"{s}/nu"], j[f"{s}/count"])
    return jax_steps.TrainState(params, slot("opt_state"), slot("opt_state2"))


def _jax_leaves(state, lazy):
    """The JAX state's leaves by the port's flat names."""
    out = {f"params/{k}": v for k, v in state.params.items()}

    def adam(prefix, st):
        out[f"{prefix}/count"] = st[0].count
        for m in ("mu", "nu"):
            out.update({f"{prefix}/{m}/{k}": v for k, v in getattr(st[0], m).items()})

    if not lazy:
        adam("opt_state", state.opt_state)
        return out
    for s in ("opt_state", "opt_state2"):
        opt = getattr(state, s)
        adam(f"{s}/dense_opt", opt.dense_opt)
        out.update({f"{s}/mu": opt.mu, f"{s}/nu": opt.nu, f"{s}/count": opt.count})
    return out


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("lazy", [False, True], ids=["dense", "lazy_dr"])
@pytest.mark.parametrize("payload", PAYLOADS)
def test_restore_equals_the_jax_package_s_bit_for_bit(tmp_path, payload, lazy):
    """Save a state in each package, restore it into a blank one of different
    values: the restored leaves are equal across packages bit for bit; full
    gives the saved values, bf16_moments the moments through bfloat16 and
    back, params_only zero moments and counts. The port writes into the
    blank state's tensors and returns that object."""
    saved = _arrays(np.random.default_rng(0), lazy)
    blank = {k: (v + 3).astype(v.dtype) for k, v in saved.items()}
    ours = CheckpointManager(str(tmp_path / "port"), payload=payload)
    ours.save(1, _port_state(saved, lazy))
    target = _port_state(blank, lazy)
    ptrs = {k: v.data_ptr() for k, v in state_leaves(target).items()}
    assert ours.restore(target) is target
    got = state_leaves(target)
    assert {k: v.data_ptr() for k, v in got.items()} == ptrs
    ours.close()

    theirs = JaxCheckpointManager(str(tmp_path / "jax"), payload=payload)
    theirs.save(1, _jax_state(saved, lazy))
    want = _jax_leaves(theirs.restore(_jax_state(blank, lazy)), lazy)
    theirs.close()

    assert got.keys() == want.keys() == saved.keys()
    for k, v in saved.items():
        np.testing.assert_array_equal(_bits(got[k].numpy()), _bits(want[k]), err_msg=k)
        a = got[k].numpy()
        assert a.dtype == v.dtype, k
        if k.startswith("params/") or payload == "full":
            np.testing.assert_array_equal(_bits(a), _bits(v), err_msg=k)
        elif payload == "params_only":
            assert not a.any(), k
        elif v.dtype == np.float32:  # bf16_moments: rounded to nearest even
            np.testing.assert_array_equal(
                _bits(a), _bits(torch.tensor(v).bfloat16().float().numpy()), err_msg=k)
            assert not np.array_equal(a, v), k
        else:
            assert a == v, k  # the counts as they were


def test_async_save_restores_the_values_of_the_save(tmp_path):
    """The snapshot is taken before save() returns: writing the state in
    place after it leaves the checkpoint as it was at the save."""
    a = _arrays(np.random.default_rng(1), True)
    state = _port_state(a, True)
    mgr = CheckpointManager(str(tmp_path / "as"), async_save=True)
    mgr.save(2, state)
    for t in state_leaves(state).values():
        t.add_(1)
    mgr.wait_until_finished()
    assert mgr.latest_step() == 2
    assert mgr.restore(state) is state
    for k, t in state_leaves(state).items():
        np.testing.assert_array_equal(_bits(t.numpy()), _bits(a[k]), err_msg=k)
    mgr.close()


def test_a_step_under_its_temporary_name_is_not_the_latest(tmp_path):
    a = _arrays(np.random.default_rng(2), False)
    mgr = CheckpointManager(str(tmp_path / "tmp"))
    assert mgr.latest_step() is None and mgr.restore(_port_state(a, False)) is None
    mgr.save(4, _port_state(a, False))
    (tmp_path / "tmp" / "5.pt.tmp").write_bytes(b"half a checkpoint")
    assert mgr.latest_step() == 4 and mgr.all_steps() == [4]
    mgr.close()


def test_keep_and_the_payload_mismatch_behave_as_the_jax_package_s(tmp_path):
    a = _arrays(np.random.default_rng(3), False)
    ours = CheckpointManager(str(tmp_path / "port"), keep=2)
    theirs = JaxCheckpointManager(str(tmp_path / "jax"), keep=2)
    for step in (1, 2, 3):
        ours.save(step, _port_state(a, False))
        theirs.save(step, _jax_state(a, False))
    theirs.wait_until_finished()
    assert ours.all_steps() == list(theirs._mgr.all_steps()) == [2, 3]
    assert ours.latest_step() == theirs.latest_step() == 3
    ours.close()
    theirs.close()
    for mgr_cls, name in ((CheckpointManager, "port"), (JaxCheckpointManager, "jax")):
        with pytest.raises(ValueError, match="was written with payload=full; resume "
                                             "with --checkpoint_payload full "
                                             r"\(got params_only\)"):
            mgr_cls(str(tmp_path / name), keep=2, payload="params_only")


def test_restore_refuses_a_state_of_other_leaves(tmp_path):
    """A checkpoint restored into a state of another structure or shape
    raises and leaves the restored-into tensors' identities alone."""
    mgr = CheckpointManager(str(tmp_path / "shape"))
    mgr.save(0, _port_state(_arrays(np.random.default_rng(4), False), False))
    with pytest.raises(ValueError, match="other leaves"):
        mgr.restore(_port_state(_arrays(np.random.default_rng(4), True), True))
    other = _port_state(_arrays(np.random.default_rng(4), False), False)
    other.params["w"] = torch.zeros(D + 1, D)
    other.opt_state.mu["w"] = other.opt_state.nu["w"] = torch.zeros(D + 1, D)
    with pytest.raises(ValueError, match="params/w has shape"):
        mgr.restore(other)
    mgr.close()


# ---------------------------------------------------------------------------
# the trainer: resume and the roll-back, both packages side by side
# ---------------------------------------------------------------------------

MODEL_KW = dict(emb_dim=8, hid_dim=4, seq_len=6, batch_size=8, item_length=90,
                user_length=90, sasrec_heads=2)


def _rows(rng, n_rows, n_items=40):
    users, s1, s2, dom = [], [], [], []
    for i in range(n_rows):
        d = int(rng.integers(0, 2))
        users.append(i)
        dom.append(d)
        s1.append(rng.integers(1, n_items, max(int(rng.integers(0, 5)), 2 - 2 * d)).tolist())
        s2.append(rng.integers(n_items, 2 * n_items,
                               max(int(rng.integers(0, 5)), 2 * d)).tolist())
    return users, s1, s2, dom, rng.integers(0, 2, n_rows).tolist()


def _data(n_rows=(32, 16)):
    rng = np.random.default_rng(0)
    rows = [_rows(rng, n) for n in n_rows]
    return ([pack_rows(*r, 6, pad_id=81) for r in rows],
            [jax_pack_rows(*r, 6, pad_id=81) for r in rows])


def _cfgs(tmp_path, backbone="sasrec", is_dr=False, **kw):
    """The same TrainConfig in both packages (the JAX model on `xla`)."""
    base = {**dict(epochs=1, lr=1e-3, seeds=1, checkpoint=True, log_every=20), **kw}
    mkw = dict(backbone=backbone, is_dr=is_dr, **MODEL_KW)
    ours = config.TrainConfig(
        model_dir=str(tmp_path / "port"), data=config.DataConfig(neg_nums=5),
        model=config.ModelConfig(**mkw), **base)
    theirs = jax_config.TrainConfig(
        model_dir=str(tmp_path / "jax"), data=jax_config.DataConfig(neg_nums=5),
        model=jax_config.ModelConfig(kernels="xla", **mkw), **base)
    return ours, theirs


@pytest.mark.parametrize("backbone", ["sasrec", "gru4rec"])
def test_resume_continues_training(tmp_path, backbone):
    """`tests/test_checkpoint.py::test_resume_continues_training` in both
    packages: a first run saves epoch 0, the resumed run starts at 1 (a
    latest step of 0 is a step)."""
    (train, val), (jtrain, jval) = _data()
    for fast in (False, True):
        ours, theirs = _cfgs(tmp_path / str(fast), backbone, fast_train=fast, fast_eval=fast)
        first = loop.run_seed(ours, 0, train, val, device="cpu")
        assert first["start_epoch"] == 0.0
        ours.epochs, ours.resume = 2, True
        best = loop.run_seed(ours, 0, train, val, device="cpu")
        assert best["start_epoch"] == 1.0 and 0.0 < best["mrr_d1"] <= 1.0
        assert (tmp_path / str(fast) / "port/checkpoint/seed0/1.pt").exists()
        assert "resumed from checkpoint at epoch 0" in (
            tmp_path / str(fast) / "port/log0.txt").read_text()
    jax_loop.run_seed(theirs, 0, jtrain, jval)
    theirs.epochs, theirs.resume = 2, True
    assert jax_loop.run_seed(theirs, 0, jtrain, jval)["start_epoch"] == 1.0


class _FakeCkpt:
    def __init__(self, restored):
        self._restored = restored
        self.restore_calls = 0

    def restore(self, state):
        self.restore_calls += 1
        return self._restored

    def latest_step(self):
        return 7


@pytest.mark.parametrize("policy,has_ckpt,want", [
    ("halt", True, None), ("restore", True, "restored-state"),
    ("restore", False, "state"), ("ignore", True, "state")])
def test_nan_policies_act_and_log_as_the_jax_package_s(caplog, policy, has_ckpt, want):
    """`tests/test_failure_detection.py`'s four policy tests, both packages'
    `_handle_nan(cfg, log, ckpt, state, epoch, step)`: the same result, the
    same restore calls and the same log text."""
    results = []
    for handle, cfg in ((loop._handle_nan, config.TrainConfig(nan_policy=policy)),
                        (jax_loop._handle_nan, jax_config.TrainConfig(nan_policy=policy))):
        ckpt = _FakeCkpt("restored-state") if has_ckpt else None
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            if want is None:
                with pytest.raises(RuntimeError, match="epoch 3 step 10") as e:
                    handle(cfg, logging.getLogger("nan"), ckpt, "state", 3, 10)
                out = type(e.value).__name__
            else:
                out = handle(cfg, logging.getLogger("nan"), ckpt, "state", 3, 10)
        results.append((out, ckpt and ckpt.restore_calls, caplog.messages))
    assert results[0] == results[1]
    assert results[0][0] == (want or "NonFiniteLossError")
    if want == "restored-state":
        assert results[0][2] == ["non-finite train loss at epoch 3 step 10; "
                                 "rolled back to checkpoint 7"]


@pytest.mark.parametrize("fast", [False, True], ids=["per_step", "chunked"])
def test_nan_at_a_non_log_step_rolls_back_to_the_checkpoint(tmp_path, monkeypatch, fast):
    """A parameter turned to NaN at epoch 1's third step (log_every=20: not a
    log step) trips the latch at the epoch's end (per step) or at the
    chunk's end (chunked); under nan_policy="restore" the port rolls back to
    checkpoint 0 in place, logs the JAX package's text, and the run ends
    with finite weights and metrics. The JAX package's run_seed, given the
    same fault at the same place, logs the same line."""
    (train, val), (jtrain, jval) = _data((48, 16))
    ours, theirs = _cfgs(tmp_path, epochs=2, fast_train=fast, fast_eval=fast,
                         nan_policy="restore")
    per_epoch = 48 // 8
    real_make = loop.make_train_step

    def make(*a, **k):
        real = real_make(*a, **k)
        calls = []

        def step(state, batch, pools, pool_sizes, key, **kw):
            calls.append(1)
            if len(calls) == per_epoch + 3:
                with torch.no_grad():
                    state.params["predict.fc1.weight"].fill_(float("nan"))
            return real(state, batch, pools, pool_sizes, key, **kw)

        step.rng = real.rng
        return step

    monkeypatch.setattr(loop, "make_train_step", make)
    final = {}
    best = loop.run_seed(ours, 0, train, val, device="cpu",
                         epoch_hook=lambda e, s, ev, phase: final.update(
                             {k: bool(torch.isfinite(v).all()) for k, v in s.params.items()}))
    step = "0" if fast else "end"
    line = f"non-finite train loss at epoch 1 step {step}; rolled back to checkpoint 0"
    assert line in (tmp_path / "port/log0.txt").read_text()
    assert all(final.values()) and all(np.isfinite(v) for v in best.values())

    # the JAX package: the same fault through its own step factories
    if fast:
        real_runner = jax_loop.make_resident_chunk_runner
        chunks = []

        def make_runner(*a, **k):
            run = real_runner(*a, **k)

            def runner(state, *rest):
                state, m0, nf = run(state, *rest)
                chunks.append(1)
                if len(chunks) == 2:  # epoch 1's one chunk
                    state = state._replace(params=jax.tree.map(
                        lambda x: x * jnp.nan, state.params))
                    nf = jnp.float32(1.0)
                return state, m0, nf

            return runner

        monkeypatch.setattr(jax_loop, "make_resident_chunk_runner", make_runner)
    else:
        real_jmake = jax_loop.make_train_step

        def jmake(*a, **k):
            real = real_jmake(*a, **k)
            calls = []

            def step(state, *rest):
                calls.append(1)
                if len(calls) == per_epoch + 3:
                    state = state._replace(params=jax.tree.map(
                        lambda x: x * jnp.nan, state.params))
                return real(state, *rest)

            return step

        monkeypatch.setattr(jax_loop, "make_train_step", jmake)
    jax_loop.run_seed(theirs, 0, jtrain, jval)
    assert line in (tmp_path / "jax/log0.txt").read_text()
