"""The pairwise mode as a whole against the JAX package, on the CPU:
a DR model with `comp_broadcast_quirk=False` (gates [B, B] from the all-pairs
max affinity), its forward and one step of each phase, with the weights moved
by amid_tpu_torch.convert, the same batches and the same negatives.

Two routes on each side. 'xla' / 'torch': fp32 affinity, plain heads and
lookups. 'force_pallas' / 'cuda': the JAX model reaches its Pallas kernels (in
interpret mode; the affinity always, the scoring head at C >= 256), the port
is built with kernels='cuda' and, its tensors lying on the CPU, goes through
the kernel wrappers' plain versions and the hand-written backwards of the
gather and scoring Functions. JAX cannot differentiate a model through its
small-N affinity kernel (`pallas_call` has no JVP rule for `program_id`), so
the step test keeps the JAX side on 'xla' and hands the 'cuda'-built port the
fp32 affinity: gates are then one function on both sides, and the Functions'
backwards are what the route adds. fp32 on both sides, dropout off; tolerance
atol 1e-5 / rtol 1e-4, as tests/test_torch_train.py."""

import dataclasses
import functools

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
from amid_tpu.train import steps as jax_steps
from amid_tpu_torch.config import ModelConfig
from amid_tpu_torch.convert import adam_state_from_optax, params_from_flax
from amid_tpu_torch.models.amid import AMIDModel
from amid_tpu_torch.ops.affinity import (
    max_affinity_blocked, max_affinity_smalln, max_affinity_xla,
)
from amid_tpu_torch.ops.embedding import embedding_gather
from amid_tpu_torch.ops.scoring import scoring_head
from amid_tpu_torch.train import steps
from amid_tpu_torch.train.optim import Adam

ATOL, RTOL = 1e-5, 1e-4
B, T, D, HEADS, VOCAB = 8, 6, 16, 2, 100  # table of 2 * VOCAB = 200 rows
LR, LR2, DR_E_W = 1e-3, 2e-3, 0.1
MODEL_KW = dict(backbone="sasrec", emb_dim=D, hid_dim=8, seq_len=T, batch_size=B,
                is_itc=True, ts2=0.1, is_dr=True, comp_broadcast_quirk=False,
                item_length=VOCAB, user_length=VOCAB, sasrec_heads=HEADS,
                sasrec_dropout=0.0)
ROUTES = [("xla", "torch"), ("force_pallas", "cuda")]
POOLS = np.tile(np.arange(2 * VOCAB, dtype=np.int32)[None], (2, 1))
POOL_SIZES = np.array([2 * VOCAB, 2 * VOCAB], np.int32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(rng, n_neg):
    v = 2 * VOCAB
    return {
        "target": rng.integers(0, v, B).astype(np.int32),
        "neg_samples": rng.integers(0, v, (B, n_neg)).astype(np.int32),
        "seq_d1": rng.integers(0, v, (B, T)).astype(np.int32),
        "seq_d2": rng.integers(0, v, (B, T)).astype(np.int32),
        "domain_id": rng.integers(0, 2, B).astype(np.int32),
        "reject": np.full((B, 1), v, np.int32),
        "reject_counts": np.zeros(B, np.int32),
        "ob_label": rng.integers(0, 2, B).astype(np.int32),
    }


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _models(rng, jax_kernels, port_kernels, fp32_affinity=False):
    """A JAX pairwise model, its parameters, and the port's model with the
    same weights. kernels='cuda' is built directly (build_model refuses it on
    the CPU): on CPU tensors every kernel wrapper takes its plain version."""
    jcfg = JaxModelConfig(**MODEL_KW, kernels=jax_kernels)
    jmodel = jax_build_model(jcfg)
    key = jax.random.PRNGKey(0)
    # under one jit each: the interpreter's callbacks then run inside one
    # dispatch, never beside an eager one (eagerly, one run in about a dozen
    # hung with several processes at once)
    with pltpu.force_tpu_interpret_mode():
        params = jax.jit(functools.partial(jmodel.init, train=False))(
            {"params": key, "dropout": key}, _jb(_batch(rng, 1)))["params"]
    port = AMIDModel(ModelConfig(**MODEL_KW, kernels=port_kernels))
    port.load_state_dict(params_from_flax(_np_tree(params)), strict=True)
    if fp32_affinity:
        for name in ("itc_d1", "itc_d2"):
            getattr(port, name).message.affinity = max_affinity_xla
    return jmodel, params, port.eval()


def _kernel_launches():
    return (embedding_gather.launches, scoring_head.launches,
            max_affinity_blocked.launches, max_affinity_smalln.launches)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("jax_kernels,port_kernels", ROUTES)
def test_pairwise_forward_matches_jax(rng, jax_kernels, port_kernels):
    """255 negatives, so C = 256 and the JAX 'force_pallas' head goes through
    its scoring kernel; gates are compared first and some must be open."""
    jmodel, params, port = _models(rng, jax_kernels, port_kernels)
    batch = _batch(rng, 255)
    before = _kernel_launches()
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(functools.partial(jmodel.apply, train=False))(
            {"params": params}, _jb(batch))
    captured = {}
    hooks = [getattr(port, n).register_forward_hook(
        lambda mod, args, out, n=n: captured.__setitem__(n, args)) for n in ("itc_d1", "itc_d2")]
    with torch.no_grad():
        got = port(_tb(batch))
    for h in hooks:
        h.remove()
    for name, args in captured.items():
        gate = getattr(port, name).message.gate(*args)
        assert tuple(gate.shape) == (B, B)
        assert 0 < gate.sum() < gate.numel(), name  # some open, some closed
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=RTOL, err_msg=key)
    assert _kernel_launches() == before  # CPU tensors launch nothing


def _optax_parts(opt_state):
    s = opt_state[0]
    return np.asarray(s.count), _np_tree(s.mu), _np_tree(s.nu)


def _assert_tree_close(got: dict, want_flax_tree, what):
    want = params_from_flax(_np_tree(want_flax_tree))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g, w = got[k].detach().numpy(), w.numpy()
        if k.endswith("in_proj_bias"):
            # the K third's gradient is analytically zero: Adam normalises
            # rounding noise there (see tests/test_torch_train.py)
            g, w = np.delete(g, slice(D, 2 * D)), np.delete(w, slice(D, 2 * D))
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("port_kernels", ["torch", "cuda"])
def test_pairwise_steps_match_jax(rng, port_kernels):
    """One phase-A and one phase-B step from one state, the negatives handed
    to both packages: losses, parameters and both optimizers' moments."""
    jmodel, params, port = _models(rng, "xla", port_kernels, fp32_affinity=True)
    tx, tx2 = optax.adam(LR), optax.adam(LR2)
    jstate = jax_steps.TrainState(params, tx.init(params), tx2.init(params))
    jstep_a = jax_steps.make_train_step(jmodel, tx, dr_e_w=DR_E_W)
    jstep_b = jax_steps.make_dr_r_step(jmodel, tx2)
    state = steps.TrainState(
        dict(port.named_parameters()),
        adam_state_from_optax(*_optax_parts(jstate.opt_state)),
        adam_state_from_optax(*_optax_parts(jstate.opt_state2)))
    step_a = steps.make_train_step(port, Adam(LR), dr_e_w=DR_E_W)
    step_b = steps.make_dr_r_step(port, Adam(LR2))
    jp, jps = jnp.asarray(POOLS), jnp.asarray(POOL_SIZES)
    tp, tps = torch.as_tensor(POOLS), torch.as_tensor(POOL_SIZES)
    before = _kernel_launches()
    for phase, (jstep, step, n_split) in enumerate(((jstep_a, step_a, 4), (jstep_b, step_b, 2))):
        batch, key = _batch(rng, 1), jax.random.PRNGKey(phase)
        # the JAX step draws its negatives from its first split key; the port
        # is handed the very same draw
        jb = _jb(batch)
        neg = np.array(jax_sample_negatives(
            jax.random.split(key, n_split)[0], jp, jps, jb["domain_id"], jb["reject"], 1,
            jb["reject_counts"]))
        step_batch = {k: v for k, v in batch.items() if k != "neg_samples"}
        with pltpu.force_tpu_interpret_mode():
            jstate, jm = jstep(jstate, _jb(step_batch), jp, jps, key)
        state, m = step(state, _tb(step_batch), tp, tps, 0, neg=neg)
        assert m.keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=ATOL, rtol=RTOL,
                                       err_msg=f"phase {phase} {k}")
    _assert_tree_close(state.params, jstate.params, "params")
    for got, want in ((state.opt_state, jstate.opt_state),
                      (state.opt_state2, jstate.opt_state2)):
        count, mu, nu = _optax_parts(want)
        assert got.count == int(count) == 1
        _assert_tree_close(got.mu, mu, "mu")
        _assert_tree_close(got.nu, nu, "nu")
    assert _kernel_launches() == before


def test_peer_message_takes_its_affinity_at_construction(rng):
    """The pairwise affinity is a constructor argument (default: the
    dispatcher bound to the model's `kernels`), so a reference for the
    kernels' gates is built by handing `max_affinity_plain` in."""
    from amid_tpu_torch.models.comp import PeerMessage
    from amid_tpu_torch.ops.affinity import max_affinity_plain

    a = torch.as_tensor(rng.normal(size=(B, T, D)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(B, T, D)).astype(np.float32))
    fp32 = PeerMessage(D, B, 0.1, broadcast_quirk=False)
    bf16 = PeerMessage(D, B, 0.1, broadcast_quirk=False, affinity=max_affinity_plain)
    via_kernels = PeerMessage(D, B, 0.1, broadcast_quirk=False, kernels="cuda")
    assert torch.equal(fp32.gate_probabilities(a, b),
                       torch.softmax(max_affinity_xla(a, b), dim=1))
    assert torch.equal(bf16.gate_probabilities(a, b),
                       torch.softmax(max_affinity_plain(a, b), dim=1))
    assert torch.equal(via_kernels.gate_probabilities(a, b), bf16.gate_probabilities(a, b))
    assert not torch.equal(fp32.gate_probabilities(a, b), bf16.gate_probabilities(a, b))
    quirk = PeerMessage(D, B, 0.1, broadcast_quirk=True, affinity=max_affinity_plain)
    assert tuple(quirk.gate(a, b).shape) == (B,)  # quirk mode never calls it
    cfg = ModelConfig(**MODEL_KW, kernels="torch")
    model = AMIDModel(dataclasses.replace(cfg, is_inc=True))
    assert {n for n, m in model.named_modules() if isinstance(m, PeerMessage)} == {
        "inc_d1.message", "inc_d2.message", "itc_d1.message", "itc_d2.message"}
