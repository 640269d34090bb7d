"""The port's parallel layer (amid_tpu_torch/parallel/) against the JAX
package's, on the CPU: ranks are gloo processes (tests/torch_mesh_worker.py,
one spawn of 2 ranks and one of 4 for the whole file, while the JAX side
runs), the JAX side on the conftest's 8 virtual devices. The shard_map
steps' parity is in tests/test_torch_spmd.py.

* `sharded_lookup` at model 2 and 4 against JAX's `sharded_lookup` under
  `shard_map`: the rows and each shard's table gradient (1e-6), and the
  collectives' own backward;
* the gspmd phase-A, phase-B and evaluation steps at 2x1, 1x2 and 2x2
  against JAX's plain steps, in the quirk and the pairwise modes: the
  metrics, the ranks, the updated parameters and both optimizers' moments
  (dropout 0, JAX's negatives);
* `state_layout` against JAX's `state_shardings` by leaf name, K1's plain
  row offset, and the scatter's dropping of shard-local ids.

Tolerance atol 1e-5 / rtol 1e-4 unless stated (sums over ranks in another
order)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from amid_tpu.config import MeshConfig as JaxMeshConfig
from amid_tpu.data.sampler import sample_negatives as jax_sample_negatives
from amid_tpu.parallel import spmd as jax_spmd
from amid_tpu.parallel.embedding import sharded_lookup as jax_sharded_lookup
from amid_tpu.parallel.mesh import _path_name, make_mesh as jax_make_mesh, state_shardings
from amid_tpu.train import lazy as jax_lazy
from amid_tpu.train import steps as jax_steps
from amid_tpu_torch.convert import adam_state_from_optax
from amid_tpu_torch.ops import attention as attention_ops
from amid_tpu_torch.ops.scatter import scatter_set_unique3_plain
from amid_tpu_torch.parallel import mesh as mesh_lib
from amid_tpu_torch.train import lazy, steps
from amid_tpu_torch.train.checkpoint import state_leaves
from amid_tpu_torch.train.optim import Adam
from test_torch_train import (
    ATOL, B, DR_E_W, LR, LR2, MODEL_KW, POOL_SIZES, POOLS, RTOL, _assert_tree_close,
    _batch, _jax_model, _jax_negatives, _jb, _optax_parts, _port_model,
)
from torch_mesh_worker import collect, start

MODES = ("quirk", "pairwise")
NUM_NEG = 19
GSPMD_SHAPES = {2: [(2, 1, "gspmd"), (1, 2, "gspmd")], 4: [(2, 2, "gspmd")]}
LOOKUP_AXES = (2, 4)  # model widths of the sharded lookup, in the 4-rank world


def _shard_negatives(key, batch, num_neg, n_split, shards):
    """The negatives JAX's shard_map steps draw: each data shard's rows from
    its own key, fold_in(key, shard) (no fold at one shard), in shard order."""
    per = B // shards
    parts = []
    for d in range(shards):
        k = jax.random.fold_in(key, d) if shards > 1 else key
        k_neg = jax.random.split(k, n_split)[0] if n_split else k
        rows = {name: jnp.asarray(v[d * per:(d + 1) * per]) for name, v in batch.items()}
        parts.append(np.asarray(jax_sample_negatives(
            k_neg, jnp.asarray(POOLS), jnp.asarray(POOL_SIZES), rows["domain_id"],
            rows["reject"], num_neg, rows["reject_counts"])))
    return np.concatenate(parts)


def _warm_adam(tx, params, rng, count):
    """optax Adam state over `params` with non-zero moments (as after
    `count` steps), so that the compared updates read them."""
    adam, *rest = tx.init(params)
    mu = jax.tree.map(lambda p: jnp.asarray(rng.normal(0, 1e-3, p.shape), p.dtype), params)
    nu = jax.tree.map(lambda p: jnp.asarray(rng.uniform(1e-8, 1e-6, p.shape), p.dtype), params)
    return (adam._replace(count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu), *rest)


def make_case(mode, impl):
    """A converted state of one mode with non-zero moments and the three
    batches with the negatives of JAX's `impl` steps (shard_map: each of 2
    data shards'), as the worker's inputs; and a function that computes
    JAX's results."""
    rng = np.random.default_rng(21 + MODES.index(mode))
    overrides = {"comp_broadcast_quirk": mode == "quirk"}
    jmodel, params, _ = _jax_model(rng, **overrides)
    tx, tx2 = optax.adam(LR), optax.adam(LR2)
    jstate = jax_steps.TrainState(params, _warm_adam(tx, params, rng, 3),
                                  _warm_adam(tx2, params, rng, 2))
    jp, jps = jnp.asarray(POOLS), jnp.asarray(POOL_SIZES)

    model = _port_model(jstate.params, **overrides)
    state = steps.TrainState(dict(model.named_parameters()),
                             adam_state_from_optax(*_optax_parts(jstate.opt_state)),
                             adam_state_from_optax(*_optax_parts(jstate.opt_state2)))
    batches = {k: _batch(rng) for k in ("a", "b", "eval")}
    keys = {k: jax.random.PRNGKey(i) for i, k in enumerate(("a", "b", "eval"))}
    case = {
        "model_kw": {**MODEL_KW, **overrides}, "params": model.state_dict(),
        "state": {k: t.detach().clone() for k, t in state_leaves(state).items()},
        "lr": (LR, LR2, DR_E_W), "pools": (POOLS, POOL_SIZES), "num_neg": NUM_NEG,
        "lazy": False, "impls": (impl,),
    }
    # (num_neg, the key's splits in the plain step, in the shard_map step)
    for k, (n, split, split_spmd) in {"a": (1, 4, 2), "b": (1, 2, 2),
                                      "eval": (NUM_NEG, 0, 0)}.items():
        case[k] = (batches[k], _jax_negatives(keys[k], batches[k], n, split)
                   if impl == "gspmd" else
                   _shard_negatives(keys[k], batches[k], n, split_spmd, 2))

    def want():
        if impl == "gspmd":
            a = jax_steps.make_train_step(jmodel, tx, dr_e_w=DR_E_W)
            b = jax_steps.make_dr_r_step(jmodel, tx2)
            ev = jax_steps.make_eval_step(jmodel, NUM_NEG)
        else:
            jmesh = jax_make_mesh(JaxMeshConfig(data_axis=2, model_axis=2))
            a = jax_spmd.make_spmd_train_step(jmodel, tx, jmesh, DR_E_W)
            b = jax_spmd.make_spmd_dr_r_step(jmodel, tx2, jmesh)
            ev = jax_spmd.make_spmd_eval_step(jmodel, NUM_NEG, jmesh)
        s, ma = a(jstate, _jb(batches["a"]), jp, jps, keys["a"])
        s, mb = b(s, _jb(batches["b"]), jp, jps, keys["b"])
        return {"a": ma, "b": mb, "state": s,
                "eval": ev(s.params, _jb(batches["eval"]), jp, jps, keys["eval"])}

    return case, want


def run_against_jax(worlds: dict, impl: str, extra: dict, tmp_path_factory):
    """Starts the ranks of each world of `worlds` ({world: shapes}) on both
    modes' cases (with `extra` jobs {world: (name, inputs)}), computes JAX's
    results meanwhile, and returns (results by world, JAX's by mode)."""
    cases, wants = {}, {}
    for mode in MODES:
        cases[mode], wants[mode] = make_case(mode, impl)
    started = {}
    try:
        for world, shapes in worlds.items():
            inputs, jobs = {"steps": {"shapes": shapes, "cases": cases}}, "steps"
            if world in extra:
                name, more = extra[world]
                inputs[name], jobs = more, f"steps+{name}"
            started[world] = start(world, jobs, inputs,
                                   str(tmp_path_factory.mktemp(f"{impl}{world}")))
        want = {mode: w() for mode, w in wants.items()}  # while the ranks run
    finally:
        out = {world: collect(h) for world, h in started.items()}
    return out, want


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both spawns' results, and what they are held against."""
    rng = np.random.default_rng(5)
    v, d = 2 * 100, 16
    lookup = {"table": torch.as_tensor(rng.normal(size=(v, d)).astype(np.float32)),
              "ids": torch.as_tensor(rng.integers(0, v, (6, 5)).astype(np.int32)),
              "ids2": torch.as_tensor(np.array([[0, 0, 199, 100], [99, 101, 7, 7]] * 3,
                                               np.int32)),
              "model_axes": LOOKUP_AXES}
    lookup["cot"] = torch.as_tensor(rng.normal(size=(6, 5, d)).astype(np.float32))
    lookup["cot2"] = torch.as_tensor(rng.normal(size=(6, 4, d)).astype(np.float32))
    out, want = run_against_jax(GSPMD_SHAPES, "gspmd", {4: ("lookup", lookup)},
                                tmp_path_factory)
    return out, want, lookup


def check_steps(got, want, what):
    for phase in ("a", "b"):
        assert got[phase].keys() == set(want[phase]) | {"nonfinite"}, what
        for k, w in want[phase].items():
            np.testing.assert_allclose(got[phase][k], float(w), atol=ATOL, rtol=RTOL,
                                       err_msg=f"{what} phase {phase} {k}")
    np.testing.assert_allclose(float(got["eval"]["loss_cls"]), float(want["eval"]["loss_cls"]),
                               atol=ATOL, rtol=RTOL, err_msg=what)
    for k in ("ranks_fixed", "ranks_raw"):
        np.testing.assert_array_equal(got["eval"][k].numpy(), np.asarray(want["eval"][k]),
                                      err_msg=f"{what} {k}")
    state, jstate = got["state"], want["state"]
    params = {k[len("params/"):]: t for k, t in state.items() if k.startswith("params/")}
    _assert_tree_close(params, jstate.params, f"{what} params")
    for slot in ("opt_state", "opt_state2"):
        count, mu, nu = _optax_parts(getattr(jstate, slot))
        assert int(state[f"{slot}/count"]) == int(count), what
        for name, tree in (("mu", mu), ("nu", nu)):
            _assert_tree_close({k.split("/", 2)[2]: t for k, t in state.items()
                                if k.startswith(f"{slot}/{name}/")}, tree, f"{what} {name}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_gspmd_steps_match_jax_plain_steps(worlds, mode, shape):
    """Every rank of the mesh holds the JAX plain steps' results."""
    out, want, _ = worlds
    world = shape[0] * shape[1]
    for rank, res in enumerate(out[world]):
        check_steps(res["steps"][(*shape, "gspmd", mode)], want[mode],
                    f"{mode} {shape} rank {rank}")


@pytest.mark.parametrize("model_axis", LOOKUP_AXES)
def test_sharded_lookup_matches_jax(worlds, model_axis):
    """Rows (both lookups of a group and the side-by-side block) and each
    shard's row gradient, against JAX's `sharded_lookup` in `shard_map` on a
    1 x model mesh, at 1e-6."""
    out, _, lk = worlds
    table, ids, ids2 = (jnp.asarray(lk[k].numpy()) for k in ("table", "ids", "ids2"))
    cot, cot2 = jnp.asarray(lk["cot"].numpy()), jnp.asarray(lk["cot2"].numpy())
    jmesh = JaxMesh(np.array(jax.devices()[:model_axis]).reshape(1, model_axis),
                    ("data", "model"))

    def lookups(tbl):
        def f(t, i, i2):
            return (jax_sharded_lookup(t, i, "model", model_axis),
                    jax_sharded_lookup(t, i2, "model", model_axis))

        return jax.shard_map(f, mesh=jmesh, in_specs=(P("model", None), P(), P()),
                             out_specs=(P(), P()))(tbl, ids, ids2)

    rows, rows2 = lookups(table)
    grad = jax.grad(lambda t: jnp.sum(lookups(t)[0] * cot) + jnp.sum(lookups(t)[1] * cot2))(
        table)
    per = table.shape[0] // model_axis
    side = np.concatenate([np.asarray(rows), np.asarray(rows2)[:, :1]], axis=1)
    for res in out[4]:
        got = res["lookup"][model_axis]
        r = got["model_rank"]
        np.testing.assert_allclose(got["rows"].numpy(), np.asarray(rows), atol=1e-6)
        np.testing.assert_allclose(got["rows2"].numpy(), np.asarray(rows2), atol=1e-6)
        np.testing.assert_allclose(got["side"].numpy(), side, atol=1e-6)
        np.testing.assert_allclose(got["grad"].numpy(),
                                   np.asarray(grad)[r * per:(r + 1) * per], atol=1e-6)


def test_collectives_backward(worlds):
    """all_gather_data: the ranks' rows in rank order; its backward, each
    rank's rows of the cotangent summed over every rank's loss. psum_model:
    the identity backward (3, not 3 x model_shards)."""
    out, _, _ = worlds
    world = len(out[4])
    xs = [torch.arange(6.0).reshape(2, 3) + 10 * r for r in range(world)]
    w = torch.arange(6.0 * world).reshape(2 * world, 3)
    total = w * sum(r + 1 for r in range(world))
    for rank, res in enumerate(out[4]):
        c = res["lookup"]["collectives"]
        assert torch.equal(c["gathered"], torch.cat(xs))
        assert torch.equal(c["grad_gather"], total[2 * rank:2 * rank + 2])
        assert torch.equal(c["grad_psum"], torch.full((2, 3), 3.0))


def _jax_sharded_names(tree, prefix):
    """Leaf names (the port's checkpoint names) that JAX row-shards."""
    names = set()
    for path, sh in jax.tree_util.tree_leaves_with_path(tree):
        if sh.spec == P("model", None):
            names.add(prefix + "/" + _path_name(path))
    return names


@pytest.mark.parametrize("kind", ["dense", "lazy"])
def test_state_layout_row_shards_the_leaves_jax_does(kind):
    """`state_layout` row-shards exactly the leaves JAX's `state_shardings`
    does, by name (the JAX tree's paths as the port's checkpoint names)."""
    rng = np.random.default_rng(3)
    jmodel, params, _ = _jax_model(rng)
    tx = optax.adam(LR)
    if kind == "dense":
        jstate = jax_steps.TrainState(params, tx.init(params), tx.init(params))
    else:
        jstate = jax_lazy.init_lazy_state(params, tx, tx)
    jmesh = jax_make_mesh(JaxMeshConfig(data_axis=4, model_axis=2))
    sh = state_shardings(jmesh, jstate)
    want = set()
    for slot in ("params", "opt_state", "opt_state2"):
        want |= _jax_sharded_names(getattr(sh, slot), slot)
    model = _port_model(params)
    if kind == "dense":
        state = steps.init_state(model, Adam(LR), Adam(LR))
    else:
        state = lazy.init_lazy_state(dict(model.named_parameters()), Adam(LR), Adam(LR))
    layout = mesh_lib.state_layout(state)
    assert layout.keys() == state_leaves(state).keys()
    got = {k for k, v in layout.items() if v == mesh_lib.ROWS}
    assert got == want and "params/item_embedding" in got
    assert set(layout.values()) == {mesh_lib.ROWS, mesh_lib.REPLICATED}


@pytest.mark.parametrize("bf16", [False, True])
def test_k1_plain_row_offset_is_the_global_row(bf16):
    """Dropout 0.1: each plain version called on rows [b0:] with
    row_offset=b0 gives, bit for bit, rows [b0:] of the call on the whole
    batch at offset 0 (masks, outputs, statistics, gradients); another
    offset draws other masks."""
    gen = torch.Generator().manual_seed(0)
    b, t, d, heads, b0, seed, rate = 6, 12, 16, 2, 4, 1234, 0.1
    q, k, v, g = (torch.randn(b, t, d, generator=gen) for _ in range(4))
    bias = torch.zeros(b, 1, 1, t)
    bias[1, ..., 5:] = -1e9
    full = attention_ops.dropout_keep_mask(seed, b, heads, t, rate)
    part = attention_ops.dropout_keep_mask(seed, b - b0, heads, t, rate, row_offset=b0)
    assert torch.equal(part, full[b0:])
    assert not torch.equal(attention_ops.dropout_keep_mask(seed, b - b0, heads, t, rate),
                           full[b0:])
    keys = range(3, 9)
    assert torch.equal(attention_ops.dropout_keep_mask(seed, 2, heads, t, rate, keys=keys,
                                                       row_offset=b0),
                       full[b0:, ..., 3:9])
    rows = slice(b0, None)

    def both(fn, *args, **kw):
        whole = fn(q, k, v, bias, *args, **kw)
        cut = fn(q[rows], k[rows], v[rows], bias[rows], *args, **kw, row_offset=b0)
        return whole, cut

    args = (seed, heads, rate)
    w, c = both(attention_ops.attention_plain, *args, mxu_bf16=bf16)
    assert torch.equal(c, w[rows])
    (wo, wm, wl), (co, cm, cl) = both(attention_ops.attention_fwd_stats_plain, *args, bf16)
    assert torch.equal(co, wo[rows]) and torch.equal(cm, wm[rows]) and torch.equal(cl, wl[rows])
    ws, cs = both(attention_ops.attention_fwd_stats_streamed_plain, *args, 4, bf16)
    assert all(torch.equal(x, y[rows]) for x, y in zip(cs, ws))
    wg = attention_ops.attention_bwd_plain(q, k, v, bias, wo, wm, wl, g, *args, bf16)
    cg = attention_ops.attention_bwd_plain(q[rows], k[rows], v[rows], bias[rows], co, cm, cl,
                                           g[rows], *args, bf16, row_offset=b0)
    assert all(torch.equal(x, y[rows]) for x, y in zip(cg, wg))
    qs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = attention_ops.attention_plain(*qs, bias, *args, mxu_bf16=bf16)
    full_grads = torch.autograd.grad((out * g).sum(), qs)
    qc = [x[rows].clone().requires_grad_() for x in (q, k, v)]
    out = attention_ops.fused_attention(*qc, bias[rows], *args, mxu_bf16=bf16, row_offset=b0)
    cut_grads = torch.autograd.grad((out * g[rows]).sum(), qc)
    assert all(torch.equal(x, y[rows]) for x, y in zip(cut_grads, full_grads))


def test_scatter_drops_the_other_shards_ids():
    """The lazy Adam on a shard writes at ids - lo: the other shards' ids
    (negative or past V_local) and the sentinel are dropped, not clamped."""
    v_local, lo = 5, 5  # shard 1 of a 10-row table over 2
    uids = torch.tensor([0, 3, 5, 7, 9, 10])  # sorted, sentinel 10
    ids = uids - lo
    arrays = [torch.zeros(v_local, 2) for _ in range(3)]
    rows = [torch.arange(12.0).reshape(6, 2) + i for i in range(3)]
    scatter_set_unique3_plain(*arrays, ids, *rows)
    for a, r in zip(arrays, rows):
        want = torch.zeros(v_local, 2)
        want[[0, 2, 4]] = r[[2, 3, 4]]
        assert torch.equal(a, want)


def test_table_the_model_axis_does_not_divide_is_refused():
    """A table of 2 * 100 rows over a model axis of 3: refused by the cut (the
    JAX package's shard_map floors it to 66 rows a shard and loses two)."""
    from amid_tpu_torch.parallel.distributed import shard_global

    mesh = mesh_lib.Mesh(1, 3, 0, 1, 1, 1, None, None)
    with pytest.raises(ValueError, match="do not split evenly"):
        shard_global(torch.zeros(200, 4), mesh_lib.ROWS, mesh)
    assert shard_global(torch.arange(12.0).reshape(6, 2), mesh_lib.ROWS, mesh).tolist() == [
        [4.0, 5.0], [6.0, 7.0]]
    assert torch.equal(shard_global(torch.ones(3), mesh_lib.REPLICATED, mesh), torch.ones(3))
