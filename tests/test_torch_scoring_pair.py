"""The scoring head for both user representations in one call
(`ops.scoring.scoring_head_pair`, what `PredictHead` calls) against the JAX
package's Pallas kernel, run on the CPU in interpret mode as the JAX
package's own tests run it: two calls of `scoring_head_pallas`, one a user
representation, on the same numpy-seeded fp32 inputs. On CPU tensors the
wrappers take their plain versions and launch nothing."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from amid_tpu.ops.pallas_scoring import scoring_head_pallas
from amid_tpu_torch.config import ModelConfig
from amid_tpu_torch.models.amid import build_model
from amid_tpu_torch.models.heads import PredictHead
from amid_tpu_torch.ops import scoring


def _inputs(seed, b, c, d=128, h=32):
    """Two users, the items and the head's parameters in torch's layout
    ([H, 2D] first layer, [1, H] second), beside the JAX kernel's [D, H] /
    [H, 1] views."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    u1, u2, items = normal(b, d), normal(b, d), normal(b, c, d)
    fc1 = normal(h, 2 * d, scale=0.05)
    b1, w2, b2 = normal(h, scale=0.05), normal(1, h, scale=0.1), normal(1, scale=0.1)
    shared = tuple(map(jnp.asarray, (fc1[:, :d].T, fc1[:, d:].T, b1, w2.T, b2)))
    return (u1, u2, items, fc1, b1, w2, b2), shared


def _torch_args(u1, u2, items, fc1, b1, w2, b2, grad=False):
    leaves = [torch.tensor(x, requires_grad=grad) for x in (u1, u2, items, fc1, b1, w2, b2)]
    tu1, tu2, titems, w, tb1, tw2, tb2 = leaves
    d = tu1.shape[1]
    return leaves, (tu1, tu2, titems, w[:, :d], w[:, d:], tb1, tw2, tb2)


@pytest.mark.parametrize("c", [200, 2, 1])
def test_scoring_head_pair_matches_two_pallas_calls(c):
    """Forward: the pair's plain version and its wrapper on CPU tensors
    against `scoring_head_pallas` once per user, rtol 1e-5 / atol 1e-6; the
    wrapper counts no launch."""
    (u1, u2, items, fc1, b1, w2, b2), shared = _inputs(0, 4, c)
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(scoring_head_pallas(jnp.asarray(u), jnp.asarray(items), *shared))
                for u in (u1, u2)]
    _, args = _torch_args(u1, u2, items, fc1, b1, w2, b2)
    before = scoring.scoring_head.launches
    for fn in (scoring.scoring_head_pair_plain, scoring.scoring_head_pair):
        got = fn(*args)
        assert len(got) == 2
        for g, w in zip(got, want):
            assert tuple(g.shape) == (4, c) and g.dtype == torch.float32
            np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-5, atol=1e-6)
    assert scoring.scoring_head.launches == before
    # each output equals the single-user head on the same inputs
    for u, g in zip(args[:2], scoring.scoring_head_pair_plain(*args)):
        assert torch.equal(g, scoring.scoring_head_plain(u, *args[2:]))


@pytest.mark.parametrize("which", ["function", "plain"])
def test_scoring_head_pair_gradients_match_the_pallas_vjp(which):
    """All eight gradients of sum(out_d1 ** 2) + sum(0.5 * out_d2 ** 3): the
    Function's backward (the item half recomputed once, both users' terms
    summed into fc1) and autograd through the plain version, against the sum
    of `jax.grad` of the Pallas function over both users. rtol 1e-4 / atol
    1e-5 (sums over B*C), the single head's tolerance."""
    (u1, u2, items, fc1, b1, w2, b2), shared = _inputs(1, 4, 130)

    def jax_loss(x1, x2, it, *params):
        o1 = scoring_head_pallas(x1, it, *params)
        o2 = scoring_head_pallas(x2, it, *params)
        return jnp.sum(o1 ** 2) + jnp.sum(0.5 * o2 ** 3)

    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(g) for g in jax.grad(jax_loss, argnums=tuple(range(8)))(
            jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(items), *shared)]
    du1, du2, ditems, dku, dki, db1, dk2, db2 = want
    want_torch = [du1, du2, ditems, np.concatenate([dku.T, dki.T], axis=1), db1, dk2.T, db2]
    leaves, args = _torch_args(u1, u2, items, fc1, b1, w2, b2, grad=True)
    fn = scoring.scoring_head_pair if which == "function" else scoring.scoring_head_pair_plain
    o1, o2 = fn(*args)
    got = torch.autograd.grad((o1 ** 2).sum() + (0.5 * o2 ** 3).sum(), leaves)
    names = ("user_d1", "user_d2", "items", "fc1", "b1", "w2", "b2")
    for name, g, w_ in zip(names, got, want_torch):
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-4, atol=1e-5, err_msg=name)


def test_scoring_head_pair_gradient_of_one_output_alone():
    """A loss on one user's scores only: the other output's gradient is zero,
    and the Function's backward equals autograd through the plain version."""
    (u1, u2, items, fc1, b1, w2, b2), _ = _inputs(2, 3, 5, d=16, h=8)
    grads = []
    for fn in (scoring.scoring_head_pair, scoring.scoring_head_pair_plain):
        leaves, args = _torch_args(u1, u2, items, fc1, b1, w2, b2, grad=True)
        _, o2 = fn(*args)
        got = torch.autograd.grad(o2.sum(), leaves, allow_unused=True)
        grads.append([torch.zeros_like(x) if g is None else g for g, x in zip(got, leaves)])
    assert torch.equal(grads[0][0], torch.zeros_like(grads[0][0]))  # user_d1's, the Function's
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)


def test_scoring_head_pair_refuses_mismatched_users():
    (u1, u2, items, fc1, b1, w2, b2), _ = _inputs(3, 3, 5, d=16, h=4)
    _, args = _torch_args(u1, u2, items, fc1, b1, w2, b2)
    with pytest.raises(ValueError, match=r"items \[B, C, D\]"):
        scoring.scoring_head_pair(args[0], args[1][:2], *args[2:])
    with pytest.raises(TypeError, match="user_d2 is torch.float64"):
        scoring.scoring_head_pair(args[0], args[1].double(), *args[2:])


@pytest.mark.parametrize("grad", [False, True])
def test_predict_head_in_cuda_form_on_the_cpu_equals_the_torch_head(grad):
    """`PredictHead(kernels='cuda')` on CPU tensors takes the pair's plain
    route (no launch) and equals the kernels='torch' head bit for bit, in the
    forward and in the gradients of its parameters."""
    gen = torch.Generator().manual_seed(0)
    heads = {k: PredictHead(16, 8, kernels=k) for k in ("cuda", "torch")}
    heads["torch"].reset_parameters(gen)
    heads["cuda"].load_state_dict(heads["torch"].state_dict())
    u1, u2 = torch.randn(4, 16, generator=gen), torch.randn(4, 16, generator=gen)
    items = torch.randn(4, 7, 16, generator=gen)
    before = scoring.scoring_head.launches
    outs = {}
    with torch.set_grad_enabled(grad):
        for kind, head in heads.items():
            o1, o2 = head(u1, u2, items)
            outs[kind] = (o1, o2)
            if grad:
                (o1.sum() + (o2 ** 2).sum()).backward()
    assert scoring.scoring_head.launches == before
    for a, b in zip(outs["cuda"], outs["torch"]):
        assert torch.equal(a, b)
    if grad:
        for (name, a), b in zip(heads["cuda"].named_parameters(), heads["torch"].parameters()):
            torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-7, msg=name)


def test_model_forward_in_cuda_form_on_the_cpu_scores_through_the_pair():
    """A kernels='cuda' model moved to the CPU scores its three DR heads
    through the pair's plain route: the logits equal the kernels='torch'
    model's on the same weights and batch."""
    cfg = ModelConfig(emb_dim=16, hid_dim=8, seq_len=6, batch_size=4, is_itc=True,
                      is_dr=True, item_length=40, user_length=40, sasrec_heads=2,
                      kernels="torch")
    plain = build_model(cfg, device="cpu")
    model = build_model(cfg, device="cpu")
    model.load_state_dict(plain.state_dict())
    for head in (model.predict, model.predict_ips, model.predict_gfunc):
        head.kernels = "cuda"
    rng = np.random.default_rng(0)
    batch = {"seq_d1": rng.integers(0, 40, (4, 6)), "seq_d2": rng.integers(0, 40, (4, 6)),
             "target": rng.integers(0, 40, 4), "neg_samples": rng.integers(0, 40, (4, 3))}
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        got, want = model(batch), plain(batch)
    keys = [k for k in want if k.startswith("logits")]
    assert keys
    for key in keys:
        assert torch.equal(got[key], want[key]), key
