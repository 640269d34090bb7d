"""The port's mesh trainer (`run_seed` with `use_mesh`, amid_tpu_torch/
parallel/) on the CPU — the counterpart of tests/test_mesh_trainer.py: gloo
ranks (tests/torch_mesh_worker.py; one spawn of 2 and one of 4 for the
file) and in-process runs on a world of one that `run_seed` makes itself.

gspmd computes the single-process function of the global batch: one epoch
of the DR schedule at 2x1, 1x2 and 2x2 with dropout on, the lazy table Adam
at 1x2, C2DSR at 2x1 and BERT4Rec and GRU4Rec with InnerComp and InterComp
at 2x1 must give the single-process port's metrics at 1e-5 (every
hit_/ndcg_/mrr key), on every rank; its fast loops engage and equal
the per-step mesh path. shard_map at 1x1 equals the single process; at 2x2
it trains the DR schedule; it refuses the lazy Adam and C2DSR with the JAX
trainer's messages."""

import dataclasses

import numpy as np
import pytest

from amid_tpu_torch.config import DataConfig, MeshConfig, ModelConfig, TrainConfig
from amid_tpu_torch.data.synthetic import synth_packed
from amid_tpu_torch.train import loop
from torch_mesh_worker import collect, start

ROWS = (64, 32, 48)  # train, val, DR


def _cfg(tmp, **kw):
    model = ModelConfig(backbone="sasrec", emb_dim=16, hid_dim=8, seq_len=6, batch_size=16,
                        item_length=90, user_length=90, sasrec_heads=2, is_dr=True,
                        is_itc=True, ts2=0.4)  # SASRec dropout 0.5: on
    model = dataclasses.replace(model, **kw.pop("model", {}))
    base = dict(epochs=1, lr=1e-3, seeds=1, checkpoint=False, model_dir=str(tmp),
                model=model, data=DataConfig(neg_nums=5), log_every=2)
    return TrainConfig(**{**base, **kw})


def _mesh(cfg, d, m, impl="gspmd", **kw):
    return dataclasses.replace(cfg, use_mesh=True, mesh_impl=impl,
                               mesh=MeshConfig(data_axis=d, model_axis=m), **kw)


def _data(cfg):
    rng = np.random.default_rng(0)
    return tuple(synth_packed(cfg.model, rng, n) for n in ROWS)


def _single(cfg):
    train, val, dr = _data(cfg)
    return loop.run_seed(cfg, 0, train, val, dr if cfg.model.is_dr else None, device="cpu")


def _metric_keys(best):
    return [k for k in best if k.startswith(("hit_", "ndcg_", "mrr"))]


BASES = {"dr": {}, "lazy": {"lazy_table_adam": True},
         "c2dsr": {"model": {"is_c2dsr": True}},
         # the other backbones with both comps: InnerComp and InterComp at
         # each backbone's placement, BERT4Rec's dropout 0.1 on
         "bert4rec_inc": {"model": {"backbone": "bert4rec", "bert_heads": 2,
                                    "bert_ff_dim": 32, "is_inc": True}},
         "gru4rec_inc": {"model": {"backbone": "gru4rec", "is_inc": True}},
         "odd_batch": {"model": {"batch_size": 15}}}
RUNS = {  # world -> name -> (base, data, model, impl, more fields); fast loops by default
    2: {"gspmd_2x1": ("dr", 2, 1, "gspmd", {}), "gspmd_1x2": ("dr", 1, 2, "gspmd", {}),
        "lazy_1x2": ("lazy", 1, 2, "gspmd", {}), "c2dsr_2x1": ("c2dsr", 2, 1, "gspmd", {}),
        "per_step_2x1": ("dr", 2, 1, "gspmd", {"fast_train": False, "fast_eval": False}),
        "bert4rec_inc_2x1": ("bert4rec_inc", 2, 1, "gspmd", {}),
        "gru4rec_inc_2x1": ("gru4rec_inc", 2, 1, "gspmd", {}),
        "odd_batch_2x1": ("odd_batch", 2, 1, "gspmd", {})},
    4: {"gspmd_2x2": ("dr", 2, 2, "gspmd", {}),
        "shard_map_2x2": ("dr", 2, 2, "shard_map", {})},
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results of every mesh run, and the single-process runs."""
    started = {}
    try:
        for world, named in RUNS.items():
            inputs = {}
            for name, (base, d, m, impl, more) in named.items():
                cfg = _cfg(tmp_path_factory.mktemp(name), **BASES[base])
                inputs[name] = {"cfg": _mesh(cfg, d, m, impl, **more), "rows": ROWS,
                                "count_chunk_runners": name == "gspmd_2x1"}
                if base == "odd_batch":
                    inputs[name]["expect_error"] = "batch_size 15 not divisible by data axis 2"
            started[world] = start(world, "run_seed", {"run_seed": {"runs": inputs}},
                                   str(tmp_path_factory.mktemp(f"ranks{world}")))
        single = {base: _single(_cfg(tmp_path_factory.mktemp(f"single_{base}"), **kw))
                  for base, kw in BASES.items() if base != "odd_batch"}  # while the ranks run
    finally:
        out = {world: [r["run_seed"] for r in collect(h)] for world, h in started.items()}
    return out, single


def _equal_on_every_rank(out, world, name, want):
    keys = _metric_keys(want)
    for rank, res in enumerate(out[world]):
        got = res[name]
        for k in keys:
            assert got[k] == pytest.approx(want[k], abs=1e-5), (name, rank, k)
        assert got == out[world][0][name], (name, rank)  # every rank the same best


@pytest.mark.parametrize("name,world", [("gspmd_2x1", 2), ("gspmd_1x2", 2),
                                        ("gspmd_2x2", 4)])
def test_gspmd_mesh_matches_single_process_with_dropout(runs, name, world):
    out, single = runs
    _equal_on_every_rank(out, world, name, single["dr"])


def test_gspmd_lazy_adam_1x2_matches_single_process(runs):
    out, single = runs
    _equal_on_every_rank(out, 2, "lazy_1x2", single["lazy"])


def test_gspmd_c2dsr_2x1_matches_single_process(runs):
    out, single = runs
    _equal_on_every_rank(out, 2, "c2dsr_2x1", single["c2dsr"])


@pytest.mark.parametrize("backbone", ["bert4rec", "gru4rec"])
def test_gspmd_other_backbones_with_both_comps_match_single_process(runs, backbone):
    """BERT4Rec (InnerComp and InterComp before its towers) and GRU4Rec
    (InterComp after them) with InnerComp on: the peer banks gathered at
    each placement."""
    out, single = runs
    _equal_on_every_rank(out, 2, f"{backbone}_inc_2x1", single[f"{backbone}_inc"])


def test_gspmd_fast_loops_engage_and_match_per_step(runs):
    """Both phases' chunk runners are built under gspmd (the default fast
    loops), and the fast run's metrics are the per-step mesh run's."""
    out, _ = runs
    for res in out[2]:
        fast, slow = res["gspmd_2x1"], res["per_step_2x1"]
        assert fast.pop("chunk_runners") == 2
        for k in _metric_keys(slow):
            assert fast[k] == pytest.approx(slow[k], abs=1e-5), k


def test_shard_map_2x2_trains_the_dr_schedule(runs):
    out, _ = runs
    for res in out[4]:
        best = res["shard_map_2x2"]
        assert np.isfinite(best["examples_per_s"]) and 0.0 <= best["hit_10_d1"] <= 1.0
        assert "mrr_d1" in best and best == out[4][0]["shard_map_2x2"]


def test_shard_map_1x1_matches_single_process(tmp_path):
    """On a 1x1 mesh every collective is over one rank and the per-shard key
    fold is skipped, so a whole epoch (per-step loops) equals the plain
    trainer's, dropout on."""
    cfg = _cfg(tmp_path / "s")
    single = _single(cfg)
    meshed = _single(_mesh(_cfg(tmp_path / "m"), 1, 1, "shard_map"))
    for k in _metric_keys(single):
        assert meshed[k] == pytest.approx(single[k], abs=1e-5), k
    assert "mesh: {'data': 1, 'model': 1} impl=shard_map processes=1" in (
        tmp_path / "m" / "log0.txt").read_text()


@pytest.mark.parametrize("field,message", [
    ({"lazy_table_adam": True}, "mesh_impl=shard_map does not cover --lazy_table_adam; use gspmd"),
    ({"model": {"is_c2dsr": True}}, "mesh_impl=shard_map does not cover --isC2DSR; use gspmd"),
])
def test_shard_map_refuses_what_it_does_not_cover(tmp_path, field, message):
    cfg = _mesh(_cfg(tmp_path, **field), 1, 1, "shard_map")
    with pytest.raises(ValueError, match=message.replace("-", r"\-")):
        loop.run_seed(cfg, 0, None, None, device="cpu")


def test_a_batch_the_data_axis_does_not_divide_is_refused(runs):
    out, _ = runs
    for res in out[2]:
        assert "not divisible by data axis 2" in res["odd_batch_2x1"]["error"]


def test_an_explicit_mesh_must_cover_the_world(tmp_path):
    with pytest.raises(ValueError, match="covers 2 of 1 ranks"):
        loop.run_seed(_mesh(_cfg(tmp_path), 2, 1), 0, None, None, device="cpu")
