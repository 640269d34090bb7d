"""`embedding_gather_many` (several lookups into one table in one launch) and
the model's grouped lookups against the JAX package's lookups.

The JAX model looks each id array up on its own (`embedding_lookup`:
`jnp.take(table, ids, axis=0)`, or through `searchsorted` on the lazy path)
and concatenates target and negatives afterwards; the port gathers a group in
one call. The same numpy-seeded table and ids go through both. A gather is a
copy, so the forward is compared exactly (atol 0); the gradient sums the same
fp32 terms in another order (atol 1e-6). On CPU tensors the port's wrappers
take their plain versions and launch nothing."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from amid_tpu.parallel.embedding import embedding_lookup
from amid_tpu_torch.config import ModelConfig
from amid_tpu_torch.models.amid import build_model
from amid_tpu_torch.ops import embedding
from amid_tpu_torch.ops.embedding import embedding_gather_many, embedding_gather_many_plain

SHAPES = [(6,), (6, 5), (6, 2, 3), (6, 1)]  # each lookup's ids: [B, ...]
V, D = 40, 8


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _inputs(rng, n, dtype=np.int32):
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = [rng.integers(0, V, s).astype(dtype) for s in SHAPES[:n]]
    return table, ids


def _torch_ids(ids):
    return [torch.as_tensor(i) for i in ids]


@pytest.mark.parametrize("fn", [embedding_gather_many, embedding_gather_many_plain],
                         ids=["wrapper", "plain"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_gather_many_equals_the_jax_lookups(rng, fn, dtype, n):
    table, ids = _inputs(rng, n, dtype)
    want = [np.asarray(embedding_lookup(jnp.asarray(table), jnp.asarray(i))) for i in ids]
    before = embedding.embedding_gather.launches
    got = fn(torch.as_tensor(table), _torch_ids(ids))
    assert isinstance(got, tuple) and len(got) == n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # side by side: what the JAX model builds with jnp.concatenate after its lookups
    side = fn(torch.as_tensor(table), _torch_ids(ids), concat=True)
    want_side = np.concatenate([w.reshape(6, -1, D) for w in want], axis=1)
    np.testing.assert_array_equal(side.numpy(), want_side)
    assert embedding.embedding_gather.launches == before  # CPU tensors launch nothing


@pytest.mark.parametrize("concat", [False, True])
@pytest.mark.parametrize("fn", [embedding_gather_many, embedding_gather_many_plain],
                         ids=["function", "plain"])
def test_gather_many_gradient_equals_jax_grad(rng, fn, concat):
    """The gradient of a weighted sum over every output: ids repeated within a
    lookup and across lookups add up in one table gradient, in the Function's
    single `index_put_` and in autograd's through the plain version alike."""
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = [np.array([3, 0, 3, 7, 39, 3], np.int32),
           np.array([[3, 3], [0, 5], [7, 7], [5, 39], [1, 3], [0, 0]], np.int64)]
    weights = [rng.normal(size=(*i.shape, D)).astype(np.float32) for i in ids]

    def jax_loss(t):
        return sum(jnp.sum(embedding_lookup(t, jnp.asarray(i)) * jnp.asarray(w))
                   for i, w in zip(ids, weights))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(table)))
    t = torch.tensor(table, requires_grad=True)
    out = fn(t, _torch_ids(ids), concat=concat)
    if concat:
        w = torch.cat([torch.as_tensor(x).reshape(6, -1, D) for x in weights], dim=1)
        loss = (out * w).sum()
    else:
        loss = sum((o * torch.as_tensor(w)).sum() for o, w in zip(out, weights))
    (got,) = torch.autograd.grad(loss, t)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    touched = sorted(set(np.concatenate([i.reshape(-1) for i in ids]).tolist()))
    assert np.flatnonzero(got.numpy().any(axis=1)).tolist() == touched


def test_gather_grad_equals_the_jax_backward(rng):
    """`embedding_gather_grad` (on CPU its plain version) against the JAX
    package's backward of the gather (`pallas_embedding._bwd`, XLA's
    scatter-add), on ids that repeat row 0 as left padding does, across
    several of the kernel's blocks of 256 sorted rows (atol 1e-4: row 0 sums
    700 fp32 terms near 1, in an order either side may choose); an id
    outside [0, V) is clamped; a CPU call launches nothing."""
    from amid_tpu.ops.pallas_embedding import _bwd

    ids = np.concatenate([np.zeros(700, np.int32), rng.integers(0, V, 300).astype(np.int32)])
    rng.shuffle(ids)
    g = rng.normal(size=(ids.size, D)).astype(np.float32)
    want, _ = _bwd(((V, D), jnp.asarray(ids)), jnp.asarray(g))
    before = embedding.embedding_gather_grad.launches
    got = embedding.embedding_gather_grad(torch.tensor(ids), torch.tensor(g), V)
    assert embedding.embedding_gather_grad.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    wild = torch.tensor([-3, V + 5])
    got = embedding.embedding_gather_grad(wild, torch.ones(2, D), V)
    assert got[0].eq(1).all() and got[V - 1].eq(1).all() and got[1:V - 1].eq(0).all()


@pytest.mark.parametrize("concat", [False, True])
def test_grad_and_no_grad_routes_agree(rng, concat):
    """With a table that wants a gradient the wrapper goes through its
    autograd.Function, without one (or under no_grad) it does not: the same
    values either way, and only the first carries a graph."""
    table, ids = _inputs(rng, 3)
    ids = _torch_ids(ids)
    leaf = torch.tensor(table, requires_grad=True)
    with_graph = embedding_gather_many(leaf, ids, concat=concat)
    with torch.no_grad():
        no_grad = embedding_gather_many(leaf, ids, concat=concat)
    frozen = embedding_gather_many(torch.tensor(table), ids, concat=concat)
    as_list = (lambda x: [x]) if concat else list
    for a, b, c in zip(as_list(with_graph), as_list(no_grad), as_list(frozen)):
        assert a.requires_grad and a.grad_fn is not None
        assert not b.requires_grad and not c.requires_grad
        assert torch.equal(a.detach(), b) and torch.equal(b, c)
    # one lookup through embedding_gather takes the same two routes
    one = embedding.embedding_gather(leaf, ids[1])
    with torch.no_grad():
        assert torch.equal(embedding.embedding_gather(leaf, ids[1]), one.detach())
    assert one.grad_fn is not None


def test_single_lookup_is_a_group_of_one(rng):
    """`embedding_gather` is `embedding_gather_many` with one id array: the
    same rows and the same table gradient, for ids of any rank (none, an empty
    one) and for a row-strided view of a wider table."""
    table, ids = _inputs(rng, 3)
    wide = torch.tensor(np.concatenate([table, table + 1], axis=1))
    for t in (torch.tensor(table), wide[:, D:]):
        for i in _torch_ids(ids) + [torch.tensor(5), torch.zeros((0, 2), dtype=torch.int64)]:
            one = embedding.embedding_gather(t, i)
            (many,) = embedding_gather_many(t, [i])
            assert tuple(one.shape) == (*i.shape, D)
            assert torch.equal(one, many) and torch.equal(one, t[i.long()])
    leaf = torch.tensor(table, requires_grad=True)
    i = torch.as_tensor(ids[1])
    (g_one,) = torch.autograd.grad(embedding.embedding_gather(leaf, i).sum(), leaf)
    (g_many,) = torch.autograd.grad(embedding_gather_many(leaf, [i])[0].sum(), leaf)
    assert torch.equal(g_one, g_many)


def test_gather_many_clamps_like_a_clipped_take(rng):
    """Ids outside [0, V) read the nearest row, as `jnp.take(mode='clip')`
    and the single-lookup wrapper do."""
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = [np.array([-3, 0, V - 1, V], np.int64), np.array([[V + 9], [5], [-1], [2]], np.int64)]
    want = [np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(i), axis=0, mode="clip"))
            for i in ids]
    for fn in (embedding_gather_many, embedding_gather_many_plain):
        for g, w in zip(fn(torch.as_tensor(table), _torch_ids(ids)), want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_gather_many_refuses_what_it_does_not_take(rng):
    table, ids = _inputs(rng, 2)
    table, ids = torch.as_tensor(table), _torch_ids(ids)
    for fn in (embedding_gather_many, embedding_gather_many_plain):
        with pytest.raises(ValueError, match="1 to 4 id arrays"):
            fn(table, [ids[0]] * 5)
        with pytest.raises(ValueError, match="1 to 4 id arrays"):
            fn(table, [])
        with pytest.raises(TypeError, match="int32 or int64"):
            fn(table, [ids[0], ids[1].float()])
        with pytest.raises(TypeError, match="float32 table"):
            fn(table.double(), ids)
        with pytest.raises(ValueError, match="share their first axis"):
            fn(table, [ids[0], ids[1][:3]], concat=True)
        with pytest.raises(ValueError, match="share their first axis"):
            fn(table, [ids[0], torch.tensor(3)], concat=True)
        with pytest.raises(ValueError, match="V >= 1"):
            fn(table[:0], ids)
        with pytest.raises(ValueError, match="V >= 1"):
            fn(table[0], ids)
    with pytest.raises(ValueError, match="not meta"):
        embedding_gather_many(table.to("meta"), [i.to("meta") for i in ids])


# ---------------------------------------------------------------------------
# the model's groups
# ---------------------------------------------------------------------------

SMALL = dict(emb_dim=16, hid_dim=8, seq_len=6, batch_size=4, is_itc=True, is_dr=True,
             item_length=20, user_length=20, sasrec_heads=2)


def _batch(rng, cfg, negatives):
    v, b = cfg.item_table_size, cfg.batch_size
    return {"seq_d1": rng.integers(0, v, (b, cfg.seq_len)),
            "seq_d2": rng.integers(0, v, (b, cfg.seq_len)),
            "target": rng.integers(0, v, b),
            "neg_samples": rng.integers(0, v, (b, negatives))}


@pytest.mark.parametrize("kernels", ["torch", "cuda"])
@pytest.mark.parametrize("lazy", [False, True])
def test_model_lookup_groups_equal_the_jax_lookups(rng, kernels, lazy):
    """`AMIDModel.lookup` on a group, direct and through the lazy path's
    unique rows (one searchsorted per group), against the JAX model's
    per-array `embedding_lookup` and its concatenation of target and
    negatives. kernels='cuda' on CPU tensors goes through the wrappers."""
    cfg = ModelConfig(**SMALL)
    model = build_model(cfg, device="cpu")
    model.cfg = dataclasses.replace(model.cfg, kernels=kernels)
    batch = _batch(rng, cfg, 9)
    table = model.item_embedding.detach()
    lazy_rows = None
    if lazy:
        uids = torch.unique(torch.cat([torch.as_tensor(v).reshape(-1) for v in batch.values()]))
        lazy_rows = (uids, table[uids])
    jt = jnp.asarray(table.numpy())
    want = {k: np.asarray(embedding_lookup(jt, jnp.asarray(v))) for k, v in batch.items()}
    with torch.no_grad():
        seq_d1, seq_d2 = model.lookup((batch["seq_d1"], batch["seq_d2"]), lazy_rows)
        cand = model.lookup((batch["target"], batch["neg_samples"]), lazy_rows, concat=True)
    np.testing.assert_array_equal(seq_d1.numpy(), want["seq_d1"])
    np.testing.assert_array_equal(seq_d2.numpy(), want["seq_d2"])
    want_cand = np.concatenate([want["target"][:, None, :], want["neg_samples"]], axis=1)
    np.testing.assert_array_equal(cand.numpy(), want_cand)
    assert cand.is_contiguous() and tuple(cand.shape) == (cfg.batch_size, 10, cfg.emb_dim)


@pytest.mark.parametrize("kernels", ["torch", "cuda"])
def test_model_forward_sends_one_table_gradient_per_group(rng, kernels):
    """The table's gradient through the grouped lookups equals the gradient
    through per-array lookups and a `torch.cat` (what the forward did before
    the lookups were grouped), for both kernel routes."""
    cfg = ModelConfig(**SMALL)
    model = build_model(cfg, device="cpu")
    model.cfg = dataclasses.replace(model.cfg, kernels=kernels)
    batch = {k: torch.as_tensor(v) for k, v in _batch(rng, cfg, 3).items()}
    out = model(batch)
    loss = sum(out[k].sum() for k in ("logits_d1", "logits_d2", "ips_d1", "gfunc_d2"))
    (got,) = torch.autograd.grad(loss, model.item_embedding)

    def separate(ids_list, lazy_rows=None, concat=False):
        rows = [embedding.embedding_gather_plain(model.item_embedding, i) for i in ids_list]
        if concat:
            return torch.cat([r.reshape(cfg.batch_size, -1, cfg.emb_dim) for r in rows], dim=1)
        return tuple(rows)

    model.lookup = separate
    ref = model(batch)
    ref_loss = sum(ref[k].sum() for k in ("logits_d1", "logits_d2", "ips_d1", "gfunc_d2"))
    (want,) = torch.autograd.grad(ref_loss, model.item_embedding)
    for k in ref:
        torch.testing.assert_close(out[k], ref[k], atol=0, rtol=0)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
