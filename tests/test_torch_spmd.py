"""The port's shard_map steps (amid_tpu_torch/parallel/spmd.py) against the
JAX package's `make_spmd_train_step`, `make_spmd_dr_r_step` and
`make_spmd_eval_step` at a 2x2 mesh, on the CPU: 4 gloo ranks
(tests/torch_mesh_worker.py) against JAX on the conftest's 8 virtual
devices, in the quirk and the pairwise modes. Dropout 0; each data shard's
negatives are the ones JAX's shard draws, rebuilt from fold_in(key, shard)
(`test_torch_parallel._shard_negatives`) and handed to the port's steps as
the global batch's. Held: the metrics, the evaluation's ranks (all-gathered
on every rank), the updated parameters and both optimizers' moments, at
atol 1e-5 / rtol 1e-4."""

import pytest
import torch

from amid_tpu_torch.ops.rng import StepRandom, fold_in
from amid_tpu_torch.parallel.context import SpmdAxes, spmd
from amid_tpu_torch.train import steps
from test_torch_parallel import MODES, check_steps, run_against_jax
from test_torch_train import B


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_against_jax({4: [(2, 2, "shard_map")]}, "shard_map", {}, tmp_path_factory)


@pytest.mark.parametrize("mode", MODES)
def test_shard_map_steps_match_jax_spmd_steps(world4, mode):
    out, want = world4
    for rank, res in enumerate(out[4]):
        check_steps(res["steps"][(2, 2, "shard_map", mode)], want[mode],
                    f"{mode} shard_map rank {rank}")


def test_every_rank_holds_the_global_results(world4):
    """Both model shards of a data shard and both data shards report the
    same metrics and the same (all-gathered) ranks."""
    out, _ = world4
    got = [res["steps"][(2, 2, "shard_map", "quirk")] for res in out[4]]
    assert len({g["a"]["loss"] for g in got}) == 1 and len({g["b"]["loss_dr_r"] for g in got}) == 1
    assert all(torch.equal(g["eval"]["ranks_raw"], got[0]["eval"]["ranks_raw"]) for g in got)
    assert got[0]["eval"]["ranks_raw"].shape == (B,)


@pytest.mark.parametrize("impl", ["shard_map", "gspmd"])
def test_a_step_cuts_its_rows_and_keys_by_impl(impl):
    """shard_map: data rank 1 of 2 cuts its rows before drawing, from the key
    folded with its data rank; gspmd: the batch stays global for the draws,
    the key unfolded, and the dropout masks take the global rows."""
    axes = SpmdAxes(data_shards=2, model_shards=1, data_rank=1, impl=impl)
    batch = {"target": torch.arange(8), "seq_d1": torch.arange(16).reshape(8, 2)}
    rng = StepRandom(None, "cpu")
    with spmd(axes):
        got_axes, got, _ = steps._mesh_start(rng, 7, batch, (None,))
    assert got_axes is axes
    if impl == "shard_map":
        assert rng.key == fold_in(7, 1) and got["target"].tolist() == [4, 5, 6, 7]
    else:
        assert rng.key == 7 and got is batch
        local, _ = steps._mesh_rows(rng, axes, batch, (None,))
        assert local["target"].tolist() == [4, 5, 6, 7] and rng.rows == (4, 8)
        assert rng.row_offset == 4
