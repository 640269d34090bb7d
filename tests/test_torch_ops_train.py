"""The plain versions of the trainer's kernels against the JAX
package: the attention backward (`attention_bwd_plain`, its residuals from
`attention_fwd_stats_plain`) against autograd of `attention_plain` and
against `jax.vjp` of the Pallas `fused_attention` in interpret mode; the unique-row scatters against the Pallas scatter kernels in
interpret mode, with a sentinel tail. fp32 on both sides."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from amid_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from amid_tpu.ops.pallas_scatter import (
    scatter_set_unique3_pallas,
    scatter_set_unique_pallas,
)
from amid_tpu_torch.ops.attention import (
    attention_backward,
    attention_bwd_plain,
    attention_fwd_stats_plain,
    attention_plain,
    fused_attention,
)
from amid_tpu_torch.ops.scatter import (
    scatter_set_unique,
    scatter_set_unique3,
    scatter_set_unique3_plain,
    scatter_set_unique_plain,
)

ATOL, RTOL = 1e-5, 1e-4  # fp32; sums in another order


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _inputs(rng, b, t, d, bias_kind):
    q, k, v, dout = (rng.normal(size=(b, t, d)).astype(np.float32) for _ in range(4))
    if bias_kind == "causal":
        bias = np.triu(np.full((t, t), -1e9, np.float32), k=1)[None, None]
    else:  # key padding [B, 1, 1, T], left padding
        lens = rng.integers(1, t + 1, b)
        ok = np.arange(t)[None, :] >= (t - lens[:, None])
        bias = np.where(ok, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    return q, k, v, bias, dout


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("bias_kind,heads", [("causal", 2), ("keypad", 4)])
def test_bwd_plain_matches_autograd_of_attention_plain(rng, rate, bias_kind, heads):
    q, k, v, bias, dout = _inputs(rng, 8, 8, 16, bias_kind)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tb, tg = torch.as_tensor(bias), torch.as_tensor(dout)
    out = attention_plain(tq, tk, tv, tb, 31, heads, rate)
    want = torch.autograd.grad(out, (tq, tk, tv), tg)
    res = attention_fwd_stats_plain(tq, tk, tv, tb, 31, heads, rate)
    got = attention_bwd_plain(tq, tk, tv, tb, *res, tg, 31, heads, rate)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL)
    # on CPU tensors the dispatching wrapper is the plain version
    for g, w in zip(attention_backward(tq, tk, tv, tb, *res, tg, 31, heads, rate), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bias_kind,heads", [("causal", 2), ("keypad", 4)])
def test_bwd_plain_matches_jax_vjp_of_the_pallas_kernel(rng, bias_kind, heads):
    q, k, v, bias, dout = _inputs(rng, 8, 8, 16, bias_kind)
    seed = jnp.zeros((1,), jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda q, k, v: jax_fused_attention(q, k, v, jnp.asarray(bias), seed, heads, 0.0),
            *map(jnp.asarray, (q, k, v)))
        want = vjp(jnp.asarray(dout))
    tq, tk, tv, tb = map(torch.as_tensor, (q, k, v, bias))
    res = attention_fwd_stats_plain(tq, tk, tv, tb, 0, heads, 0.0)
    got = attention_bwd_plain(tq, tk, tv, tb, *res, torch.as_tensor(dout), 0, heads, 0.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_dropout_mask_is_the_same_in_forward_and_backward(rng):
    """With one-hot dO and V = 1 the backward's dV exposes Pd: it must be the
    forward's dropped probabilities, element for element."""
    b, t, d, heads, seed, rate = 2, 6, 8, 1, 5, 0.5
    q, k, _, bias, _ = _inputs(rng, b, t, d, "causal")
    tq, tk, tb = (torch.as_tensor(x) for x in (q, k, bias))
    eye_v = torch.zeros(b, t, d)
    eye_v[:, torch.arange(t), torch.arange(t)] = 1.0  # V = I: out[i, j] = Pd[i, j]
    pd_fwd = fused_attention(tq, tk, eye_v, tb, seed, heads, rate)[..., :t]
    res = attention_fwd_stats_plain(tq, tk, eye_v, tb, seed, heads, rate)
    _, _, dv = attention_bwd_plain(tq, tk, eye_v, tb, *res, eye_v, seed, heads, rate)
    # dV = Pd^T dO with dO = I  ->  dV[j, i] = Pd[i, j]
    torch.testing.assert_close(dv[..., :t].transpose(1, 2), pd_fwd, atol=1e-7, rtol=0)
    assert (pd_fwd == 0).sum() > (torch.triu(torch.ones(t, t), 1) == 1).sum() * b


def _ids_with_sentinel_tail(rng, v, n_real, n_tail):
    ids = np.sort(rng.permutation(v)[:n_real])
    ids[0], ids[-1] = 0, v - 1  # first and last row of the table
    return np.concatenate([np.unique(ids), np.full(n_tail, v)]).astype(np.int32)


def test_scatter3_plain_matches_pallas_interpret(rng):
    v, d = 64, 128
    ids = _ids_with_sentinel_tail(rng, v, 20, 7)
    tabs = [rng.normal(size=(v, d)).astype(np.float32) for _ in range(3)]
    rows = [rng.normal(size=(len(ids), d)).astype(np.float32) for _ in range(3)]
    with pltpu.force_tpu_interpret_mode():
        want = scatter_set_unique3_pallas(*map(jnp.asarray, tabs), jnp.asarray(ids),
                                          *map(jnp.asarray, rows))
    for fn in (scatter_set_unique3_plain, scatter_set_unique3):  # CPU: both plain
        got = fn(*[torch.tensor(t) for t in tabs], torch.as_tensor(ids),
                 *map(torch.as_tensor, rows))
        for g, w, before in zip(got, want, tabs):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            touched = np.zeros(v, bool)
            touched[ids[ids < v]] = True
            np.testing.assert_array_equal(g.numpy()[~touched], before[~touched])


@pytest.mark.parametrize("row_shape", [(128,), (3, 128)])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_scatter_plain_matches_pallas_interpret(rng, row_shape, id_dtype):
    v = 48
    ids = _ids_with_sentinel_tail(rng, v, 20, 5)
    table = rng.normal(size=(v, *row_shape)).astype(np.float32)
    rows = rng.normal(size=(len(ids), *row_shape)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(scatter_set_unique_pallas(
            jnp.asarray(table), jnp.asarray(ids), jnp.asarray(rows)))
    for fn in (scatter_set_unique_plain, scatter_set_unique):
        got = fn(torch.tensor(table), torch.as_tensor(ids).to(id_dtype),
                 torch.as_tensor(rows))
        np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_writes_in_place_into_a_parameter(rng):
    """The write lands in the parameter's own storage: data_ptr, the
    state_dict entry and an alias all see it, and sentinel rows are dropped,
    not clamped onto row V-1."""
    v, d = 10, 4
    param = torch.nn.Parameter(torch.zeros(v, d))
    alias, ptr = param.detach(), param.data_ptr()
    ids = torch.tensor([2, 5, v, v], dtype=torch.int32)
    rows = torch.arange(16, dtype=torch.float32).reshape(4, d) + 1
    out = scatter_set_unique(param, ids, rows)
    assert out is param and param.data_ptr() == ptr and param.requires_grad
    assert torch.equal(alias[2], rows[0]) and torch.equal(alias[5], rows[1])
    assert torch.count_nonzero(alias[v - 1]) == 0
    assert torch.count_nonzero(alias) == 2 * d


@pytest.mark.parametrize("bad", ["rows_shape", "ids_dtype", "table_dtype", "not_contiguous"])
def test_scatter_rejects_what_the_kernel_does_not_take(bad):
    table, ids, rows = torch.zeros(6, 4), torch.tensor([1, 2]), torch.zeros(2, 4)
    if bad == "rows_shape":
        rows = torch.zeros(3, 4)
    elif bad == "ids_dtype":
        ids = ids.to(torch.int16)
    elif bad == "table_dtype":
        table = table.double()
    else:
        table = torch.zeros(4, 6).t()
    with pytest.raises((ValueError, TypeError)):
        scatter_set_unique(table, ids, rows)
