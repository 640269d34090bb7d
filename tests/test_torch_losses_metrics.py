"""The port's losses and ranking metrics against the JAX package's, on the
numpy cases of tests/test_losses.py, test_metrics.py and
test_eval_protocol.py. fp32; losses within 1e-6, ranks and metrics equal."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from amid_tpu.train import losses as jax_losses
from amid_tpu.train import metrics as jax_metrics
from amid_tpu_torch.train import losses, metrics

TOL = 1e-6  # fp32 scalar losses, the same formula on both sides


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _rand_out(rng, b, c):
    out = {k: rng.uniform(0.05, 0.95, (b, c)).astype(np.float32)
           for k in ("logits_d1", "logits_d2")}
    for k in ("ips_d1", "ips_d2", "gfunc_d1", "gfunc_d2"):
        out[k] = rng.uniform(0.1, 0.9, (b, c)).astype(np.float32)
    return out


def _case(rng, b=6, c=3):
    out = _rand_out(rng, b, c)
    labels = np.zeros((b, c), np.float32)
    labels[:, 0] = 1
    dom = rng.integers(0, 2, b).astype(np.int32)
    ob = rng.integers(0, 2, b).astype(np.int32)
    return out, labels, dom, ob


@pytest.mark.parametrize("name", ["masked_bce_loss", "dr_e_loss", "dr_r_loss"])
def test_losses_match_jax(rng, name):
    out, labels, dom, ob = _case(rng)
    jout = {k: jnp.asarray(v) for k, v in out.items()}
    tout = {k: torch.as_tensor(v) for k, v in out.items()}
    jl, jd, jo = jnp.asarray(labels), jnp.asarray(dom), jnp.asarray(ob)
    tl, td, to = torch.as_tensor(labels), torch.as_tensor(dom), torch.as_tensor(ob)
    if name == "masked_bce_loss":
        want = jax_losses.masked_bce_loss(jout["logits_d1"], jout["logits_d2"], jl, jd)
        got = losses.masked_bce_loss(tout["logits_d1"], tout["logits_d2"], tl, td)
    elif name == "dr_e_loss":
        want, got = jax_losses.dr_e_loss(jout, jl, jd), losses.dr_e_loss(tout, tl, td)
    else:
        want = jax_losses.dr_r_loss(jout, jl, jd, jo)
        got = losses.dr_r_loss(tout, tl, td, to)
    assert abs(float(got) - float(want)) < TOL


def test_masked_bce_matches_torch_bceloss(rng):
    out, labels, dom, _ = _case(rng)
    crit = torch.nn.BCELoss(reduction="none")
    p1, p2, lab = (torch.tensor(x) for x in (out["logits_d1"], out["logits_d2"], labels))
    m2 = torch.tensor(dom).unsqueeze(1).float()
    want = torch.mean(crit(p1, lab) * (1 - m2) + crit(p2, lab) * m2)
    got = losses.masked_bce_loss(p1, p2, lab, torch.tensor(dom))
    assert abs(float(got) - float(want)) < TOL


def test_bce_clamps_the_log_at_minus_100():
    pred = torch.tensor([0.0, 1.0, 0.0, 1.0])
    label = torch.tensor([1.0, 0.0, 0.0, 1.0])
    got = losses.bce(pred, label)
    want = np.asarray(jax_losses.bce(jnp.asarray(pred.numpy()), jnp.asarray(label.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), [100.0, 100.0, 0.0, 0.0])
    assert torch.isfinite(got).all()


def _reference_ranks(pred, fix):
    pred = pred.copy()
    if fix:
        pred[:, 0] = pred[:, 0] - metrics.FIX_VALUE
    return (-pred).argsort(kind="stable").argsort(kind="stable")[:, 0]


@pytest.mark.parametrize("fix", [True, False])
def test_positive_ranks_match_jax_and_double_argsort(rng, fix):
    pred = rng.uniform(size=(64, 12)).astype(np.float32)
    pred[:4, 1] = pred[:4, 0]  # ties between the positive and a negative
    got = metrics.positive_ranks(torch.as_tensor(pred), fix=fix)
    assert got.dtype == torch.int32
    want = np.asarray(jax_metrics.positive_ranks(jnp.asarray(pred), fix=fix))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _reference_ranks(pred, fix))


@pytest.mark.parametrize("n", [100, 0])
def test_rank_metrics_match_jax(rng, n):
    ranks = rng.integers(0, 30, size=n)
    assert metrics.rank_metrics(ranks) == jax_metrics.rank_metrics(ranks)
    assert metrics.FIX_VALUE == jax_metrics.FIX_VALUE and metrics.TOP_KS == jax_metrics.TOP_KS


@pytest.mark.parametrize("overlap_eval", [True, False])
def test_eval_pipeline_matches_jax_accumulator(rng, overlap_eval):
    n, negs = 128, 19
    pred_d1 = rng.uniform(size=(n, 1 + negs)).astype(np.float32)
    pred_d2 = rng.uniform(size=(n, 1 + negs)).astype(np.float32)
    dom = rng.integers(0, 2, n).astype(np.int32)
    overlap = rng.integers(0, 2, n).astype(np.int32)
    acc = metrics.RankAccumulator(overlap_eval)
    jacc = jax_metrics.RankAccumulator(overlap_eval)
    for sl in (slice(0, 64), slice(64, 128)):
        pred = np.where(dom[sl, None] == 0, pred_d1[sl], pred_d2[sl])
        tp, jp = torch.as_tensor(pred), jnp.asarray(pred)
        # ranks stay tensors until finalize(), as in the eval loop
        acc.add(metrics.positive_ranks(tp, True), metrics.positive_ranks(tp, False),
                dom[sl], overlap[sl])
        jacc.add(np.asarray(jax_metrics.positive_ranks(jp, True)),
                 np.asarray(jax_metrics.positive_ranks(jp, False)), dom[sl], overlap[sl])
    got, want = acc.finalize(), jacc.finalize()
    assert got.keys() == want.keys() and len(got) == (42 if overlap_eval else 14)
    for k, v in want.items():
        assert abs(got[k] - v) < 1e-9, k


def test_empty_accumulator_finalizes_to_zeros():
    got = metrics.RankAccumulator(True).finalize()
    assert got and all(v == 0.0 for v in got.values())
