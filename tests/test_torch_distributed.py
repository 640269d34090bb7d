"""The port's multi-node layer (amid_tpu_torch/parallel/distributed.py) on
the CPU, with real gloo ranks (tests/torch_mesh_worker.py) — the
counterpart of tests/test_distributed.py. A JAX process is a node here, the
ranks that share `LOCAL_WORLD_SIZE`:

* two nodes of one rank each (`LOCAL_WORLD_SIZE=1`): a gspmd DR epoch equals
  the single-process port's metrics at 1e-5, shard_map is refused with the
  JAX trainer's message, and the node helpers (`host_local_slice`,
  `make_host_aligned_mesh`) see two nodes;
* a 1x2 run's checkpoint equals a single-process run's leaf for leaf (rank 0
  gathers the table's row shards), a restore into a 1x2 state hands each
  rank its rows in place, and a NaN under nan_policy="restore" rolls the
  mesh run back;
* the trainer CLI with `--distributed True --coordinator ... --num_processes
  2 --process_id i` joins the world itself and trains on it;
* `initialize_distributed`: a no-op with no world to join, and an error for
  a half-given explicit world."""

import dataclasses

import numpy as np
import pytest
import torch

from amid_tpu_torch.config import DataConfig, ModelConfig
from amid_tpu_torch.data.synthetic import write_synthetic_csvs
from amid_tpu_torch.parallel.distributed import initialize_distributed
from test_torch_mesh_trainer import ROWS, _cfg, _mesh, _metric_keys, _single
from torch_mesh_worker import collect, spawn, start

NAN_PARAM = "predict_gfunc.fc1.weight"  # read by phase B's loss (the imputation head)


@pytest.fixture(scope="module")
def two_nodes(tmp_path_factory):
    runs = {"gspmd": {"cfg": _mesh(_cfg(tmp_path_factory.mktemp("n2")), 2, 1), "rows": ROWS},
            "shard_map": {"cfg": _mesh(_cfg(tmp_path_factory.mktemp("n2s")), 2, 1, "shard_map"),
                          "rows": ROWS,
                          "expect_error": "multi-process runs require mesh_impl=gspmd"}}
    started = start(2, "run_seed+world", {"run_seed": {"runs": runs},
                                          "world": {"rows": 16, "model_axes": (1, 2)}},
                    str(tmp_path_factory.mktemp("nodes")), env={"LOCAL_WORLD_SIZE": "1"})
    try:
        single = _single(_cfg(tmp_path_factory.mktemp("n1")))  # while the ranks run
    finally:
        out = collect(started)
    return out, single


def test_two_nodes_gspmd_dr_matches_single_process(two_nodes):
    out, single = two_nodes
    for rank, res in enumerate(out):
        got = res["run_seed"]["gspmd"]
        for k in _metric_keys(single):
            assert got[k] == pytest.approx(single[k], abs=1e-5), (rank, k)
        assert got == out[0]["run_seed"]["gspmd"]


def test_two_nodes_refuse_shard_map(two_nodes):
    out, _ = two_nodes
    for res in out:
        assert "multi-process runs require mesh_impl=gspmd" in res["run_seed"]["shard_map"]["error"]


def test_node_helpers_see_two_nodes(two_nodes):
    """host_local_slice: each node its half of 16 rows; make_host_aligned_mesh
    keeps `model` within a node: model 1 gives a 2x1 mesh over 2 nodes, model
    2 exceeds a node's one rank (the JAX message)."""
    out, _ = two_nodes
    for rank, res in enumerate(out):
        w = res["world"]
        assert w["slice"] == (8 * rank, 8 * rank + 8)
        assert w[1] == {"shape": {"data": 2, "model": 1}, "nodes": 2, "coords": (rank, 0)}
        assert w[2] == {"error": "model_axis=2 must divide local device count 1"}


@pytest.fixture(scope="module")
def checkpointed(tmp_path_factory):
    cfg = _cfg(tmp_path_factory.mktemp("c1x2"), checkpoint=True, checkpoint_keep=2)
    started = start(2, "checkpoint", {"checkpoint": {"cfg": _mesh(cfg, 1, 2), "rows": ROWS,
                                                     "nan_param": NAN_PARAM}},
                    str(tmp_path_factory.mktemp("ckpt")))
    single_cfg = dataclasses.replace(cfg, model_dir=str(tmp_path_factory.mktemp("c1")))
    try:
        single = _single(single_cfg)
    finally:
        out = collect(started)
    return out, cfg, single_cfg, single


def _file(cfg):
    return torch.load(f"{cfg.model_dir}/checkpoint/seed0/0.pt", weights_only=True)


def test_mesh_checkpoint_equals_single_process_leaf_for_leaf(checkpointed):
    out, cfg, single_cfg, single = checkpointed
    got, want = _file(cfg)["leaves"], _file(single_cfg)["leaves"]
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        torch.testing.assert_close(got[k], want[k], atol=1e-5, rtol=1e-4, msg=k)
    for k in _metric_keys(single):
        assert out[0]["checkpoint"]["best"][k] == pytest.approx(single[k], abs=1e-5), k


def test_restore_into_the_mesh_hands_each_rank_its_rows(checkpointed):
    out, cfg, _, _ = checkpointed
    saved = _file(cfg)["leaves"]
    for res in (r["checkpoint"] for r in out):
        assert res["same_object"]
        rank = res["model_rank"]
        for k, t in res["leaves"].items():
            want = saved[k]
            if res["layout"][k] == "model":
                per = want.shape[0] // 2
                want = want[rank * per:(rank + 1) * per]
            assert torch.equal(t, want), k
        assert sum(v == "model" for v in res["layout"].values()) == 5  # table, 2 x (mu, nu)


def test_nan_rolls_the_mesh_run_back(checkpointed):
    out, cfg, _, _ = checkpointed
    log = open(f"{cfg.model_dir}/log0.txt").read()
    assert "resumed from checkpoint at epoch 0" in log
    assert "rolled back to checkpoint 0" in log
    for r in out:
        resumed = r["checkpoint"]["resumed"]
        assert resumed["start_epoch"] == 1.0
        assert all(np.isfinite(resumed[k]) for k in _metric_keys(resumed))


def test_cli_joins_the_world_itself(tmp_path):
    """train_sr_dr.main with --distributed and the explicit world flags on
    2 ranks: rank 0 writes log_all.txt, both return the same aggregate."""
    data = DataConfig(dataset_type="toy", domain_type="a_b", data_root=str(tmp_path / "data"),
                      overlap_ratio=0.25)
    write_synthetic_csvs(data, ModelConfig(seq_len=6), np.random.default_rng(0), 64, 32, 48)
    argv = ["--seq_len", "6", "--bs", "16", "--emb_dim", "16", "--hid_dim", "8",
            "--neg_nums", "9", "--isItC", "True", "--ts2", "0.4", "--epoch", "1", "--seeds",
            "1", "-ds", "toy", "-dm", "a_b", "--overlap_ratio", "0.25", "--data_root",
            data.data_root, "-md", str(tmp_path / "model"), "--device", "cpu",
            "--checkpoint", "False", "--distributed", "True", "--model_axis", "2"]
    out = spawn(2, "cli", {"cli": {"argv": argv}}, str(tmp_path / "ranks"))
    assert [r["cli"]["world"] for r in out] == [2, 2]
    assert out[0]["cli"]["agg"] == out[1]["cli"]["agg"]
    assert 0.0 < out[0]["cli"]["agg"]["mrr_d1"]["mean"] <= 1.0
    log_all = (tmp_path / "model" / "log_all.txt").read_text()
    assert "mesh: {'data': 1, 'model': 2} impl=gspmd processes=1" in (
        tmp_path / "model" / "log0.txt").read_text()
    assert '"model_axis": 2' in log_all and "mrr_d1:" in log_all


def test_initialize_distributed_without_a_world_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("args", [("localhost:1", None, None), (None, 2, 0),
                                  (None, None, 1)])
def test_a_half_given_explicit_world_raises(args):
    with pytest.raises(ValueError, match="--coordinator, --num_processes and --process_id"):
        initialize_distributed(*args, device="cpu")
    assert not torch.distributed.is_initialized()
