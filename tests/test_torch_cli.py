"""The port's trainer entry: `config.parse_cli` against the JAX package's,
field by field; `train.loop.run` and the two CLIs on a tiny synthetic CSV on
the CPU; and, on identical weights, the JAX and the torch evaluation passes
over the CSV's test split."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from amid_tpu import config as jax_config
from amid_tpu.data.loader import BatchIterator as JaxBatchIterator
from amid_tpu.data.packed import load_dual_domain_csv as jax_load_csv
from amid_tpu.data.sampler import sample_negatives as jax_sample_negatives
from amid_tpu.models.amid import build_model as jax_build_model
from amid_tpu.train import loop as jax_loop
from amid_tpu.train import steps as jax_steps
from amid_tpu_torch import config, train_sr, train_sr_dr
from amid_tpu_torch.convert import params_from_flax
from amid_tpu_torch.data.loader import BatchIterator
from amid_tpu_torch.data.packed import load_dual_domain_csv
from amid_tpu_torch.data.synthetic import write_synthetic_csvs
from amid_tpu_torch.models.amid import build_model
from amid_tpu_torch.train import loop, steps

RUN_SH = ["--overlap_ratio", "0.25", "-ds", "mybank", "-dm", "loan_account", "--model",
          "sasrec", "--overlap", "True", "--isItC", "True", "--ts2", "0.4", "--neg_nums",
          "999", "--lr2", "0.01", "--dr_e_w", "0.01"]
# what the port's parse_cli may answer differently, and why
DOCUMENTED = {"data.data_root"}  # no machine path in the port


def _flat(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": x for k, x in _flat(v).items()})
        else:
            out[f.name] = v
    return out


@pytest.mark.parametrize("argv,is_dr", [
    ([], False),
    ([], True),
    (RUN_SH, True),
    (RUN_SH + ["--comp_broadcast_quirk", "False", "--lazy_table_adam", "True", "--seq_len",
               "150", "--bs", "128", "--seeds", "2", "--seed_offset", "3", "-md", "out/",
               "--fast_train", "False", "--checkpoint", "no", "--subdomain", "1"], True),
    (["--mesh", "True"], False),
    (["--model_axis", "2", "--isInC", "1", "--ts1", "0.3", "--isC2DSR", "true"], False),
])
def test_parse_cli_equals_the_jax_package_s_field_by_field(argv, is_dr):
    ours = _flat(config.parse_cli(argv, is_dr=is_dr))
    theirs = _flat(jax_config.parse_cli(argv, is_dr=is_dr))
    assert ours.keys() == theirs.keys()
    differ = {k for k in ours if ours[k] != theirs[k]}
    assert differ <= DOCUMENTED, {k: (ours[k], theirs[k]) for k in differ}
    assert ours["data.data_root"] == "reference"


def test_parse_cli_documented_differences():
    """--kernels is the port's own (auto|torch|cuda, checked); --device is a
    flag and no config field, absent means the card; --data_root given is
    taken as it is."""
    cfg, device = config.parse_cli_with_device(["--kernels", "cuda", "--data_root", "d"])
    assert (cfg.model.kernels, cfg.data.data_root, device) == ("cuda", "d", None)
    assert config.parse_cli_with_device(["--device", "cpu"])[1] == "cpu"
    for bad in ("xla", "pallas", "force_pallas"):
        with pytest.raises(SystemExit):
            config.parse_cli(["--kernels", bad])
    assert "device" not in _flat(cfg)
    # --distributed with no world to join (no torchrun environment, no
    # --coordinator) joins none, as the JAX CLI's; it asks for the mesh
    assert config.parse_cli(["--distributed", "True"]).use_mesh
    assert not torch.distributed.is_initialized()


TINY = ["--seq_len", "6", "--bs", "16", "--emb_dim", "16", "--hid_dim", "8", "--neg_nums", "9",
        "--isItC", "True", "--ts2", "0.4", "--epoch", "1", "--seeds", "1",
        "-ds", "toy", "-dm", "a_b", "--overlap_ratio", "0.25", "--lazy_table_adam", "True"]


@pytest.fixture(scope="module")
def csv_root(tmp_path_factory):
    """A tiny dataset in the reference's CSV format: 64 train, 32 test and 48
    DR rows over the reference's id space (parse_cli does not set the vocab)."""
    root = tmp_path_factory.mktemp("data")
    data = config.DataConfig(dataset_type="toy", domain_type="a_b", data_root=str(root),
                             overlap_ratio=0.25)
    paths = write_synthetic_csvs(data, config.ModelConfig(seq_len=6), np.random.default_rng(0),
                                 64, 32, 48)
    assert [p.split("/")[-1] for p in paths] == [
        "a_b_train25.csv", "a_b_test.csv", "a_b_train25_DR.csv"]
    return str(root)


@pytest.mark.parametrize("cli,pairwise", [(train_sr_dr, True), (train_sr_dr, False),
                                          (train_sr, False)])
def test_cli_trains_one_epoch_from_a_csv_on_the_cpu(tmp_path, csv_root, cli, pairwise):
    _train_one_epoch(tmp_path, csv_root, cli, pairwise)


@pytest.mark.parametrize("model", ["bert4rec", "GRU4Rec"])
@pytest.mark.parametrize("cli,pairwise", [(train_sr_dr, True), (train_sr, False)])
def test_cli_trains_each_backbone_one_epoch_on_the_cpu(tmp_path, csv_root, cli, pairwise,
                                                       model):
    """`--model` in any case, as the reference's scripts spell it."""
    _train_one_epoch(tmp_path, csv_root, cli, pairwise, model)


def _train_one_epoch(tmp_path, csv_root, cli, pairwise, model="sasrec"):
    argv = TINY + ["--device", "cpu", "--kernels", "torch", "--data_root", csv_root,
                   "-md", str(tmp_path), "--comp_broadcast_quirk", str(not pairwise),
                   "--model", model]
    agg = cli.main(argv)
    assert {"hit_10_d1", "ndcg_10_d2", "mrr_d1", "mrr_d2", "examples_per_s"} <= agg.keys()
    assert all(np.isfinite(v["mean"]) and v["std"] == 0.0 for v in agg.values())
    log_all = (tmp_path / "log_all.txt").read_text()
    _assert_default_checkpoint(tmp_path, log_all)
    assert '"comp_broadcast_quirk": %s' % str(not pairwise).lower() in log_all
    assert "mrr_d1:" in log_all
    log0 = (tmp_path / "log0.txt").read_text()
    assert "epoch 0/1 val_loss=" in log0
    is_dr = cli is train_sr_dr
    assert ("epoch 0 (post-DR)" in log0) == is_dr
    assert ('"is_dr": true' in log_all) == is_dr
    assert f'"backbone": "{model.lower()}"' in log_all


def _assert_default_checkpoint(model_dir, log_all):
    """The JAX CLI's defaults: a checkpoint of the last epoch (0) under
    model_dir/checkpoint/seed0, full payload; nothing turned off."""
    ckpt = model_dir / "checkpoint" / "seed0"
    assert sorted(p.name for p in ckpt.iterdir()) == ["0.pt", "payload_mode.txt"]
    assert (ckpt / "payload_mode.txt").read_text() == "full"
    assert "turned off" not in log_all


def test_cli_runs_on_the_card_unless_asked_and_refuses_unported_parts(
        tmp_path, csv_root, monkeypatch):
    """Without --device the card (and there is none); --mesh True (refused
    until the parallel layer was ported) trains on a world of one gloo rank
    that the run makes and destroys; --resume True starts after the saved
    epoch, --profile_steps 2 writes a trace (both ported: they run on the
    CPU); C2DSR as below."""
    base = TINY + ["--data_root", csv_root, "-md", str(tmp_path)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_sr_dr.main(base)  # no --device: the card, and there is none
    cpu = ["--device", "cpu", "--kernels", "torch"]
    agg = train_sr_dr.main(base + cpu + ["--mesh", "True", "-md", str(tmp_path / "mesh")])
    assert 0.0 < agg["mrr_d1"]["mean"] <= 1.0
    assert "mesh: {'data': 1, 'model': 1} impl=gspmd processes=1" in (
        tmp_path / "mesh/log0.txt").read_text()
    assert not torch.distributed.is_initialized()
    train_sr_dr.main(base + cpu + ["-md", str(tmp_path / "resume")])
    agg = train_sr_dr.main(base + cpu + ["-md", str(tmp_path / "resume"), "--resume", "True",
                                         "--epoch", "2"])
    assert agg["start_epoch"]["mean"] == 1.0 and 0.0 < agg["mrr_d1"]["mean"] <= 1.0
    assert "resumed from checkpoint at epoch 0" in (tmp_path / "resume/log0.txt").read_text()
    train_sr_dr.main(base + cpu + ["-md", str(tmp_path / "profile"), "--profile_steps", "2"])
    assert len(list((tmp_path / "profile/profile").glob("*.pt.trace.json"))) == 1
    # C2DSR trains on the CPU with dense Adam and logs loss_cl; with the lazy
    # table Adam it raises the JAX trainer's ValueError
    c2dsr = base + ["--device", "cpu", "--kernels", "torch", "--isC2DSR", "True"]
    with pytest.raises(ValueError, match="^--isC2DSR is not supported with --lazy_table_adam$"):
        train_sr_dr.main(c2dsr)
    agg = train_sr_dr.main(c2dsr + ["--lazy_table_adam", "False"])
    assert all(np.isfinite(v["mean"]) for v in agg.values())
    assert "loss_cl:" in (tmp_path / "log0.txt").read_text()
    with pytest.raises(ValueError, match="unknown backbone 'caser'"):
        train_sr_dr.main(base + ["--device", "cpu", "--model", "Caser"])
    with pytest.raises(ValueError, match="kernels='cuda' needs a CUDA device"):
        train_sr_dr.main(base + ["--device", "cpu", "--kernels", "cuda"])


@pytest.mark.parametrize("flag,field,value", [
    (["--bf16", "True"], "use_bf16", True),
    (["--matmul_precision", "bfloat16"], "matmul_precision", "bfloat16"),
    (["--remat", "True"], "remat", True),
])
def test_precision_flags_parse_as_in_the_jax_package_and_are_refused(
        tmp_path, csv_root, flag, field, value):
    """The three flags fill the JAX package's fields, and the port now runs
    them: `build_model` takes the field (the bf16 mode, or SASRec's
    rematerialised blocks) and the CLI trains one epoch with the flag, all
    its metrics finite. (Until the precision flags were ported the run
    refused each of them with a NotImplementedError naming the field; the
    name of this test is kept from then.) `--matmul_precision highest`
    trains on the fp32 path."""
    base = TINY + ["--data_root", csv_root, "-md", str(tmp_path), "--device", "cpu",
                   "--kernels", "torch"]
    got = config.parse_cli(base[:-4] + flag, is_dr=True).model
    want = jax_config.parse_cli(base[:-4] + flag, is_dr=True).model
    assert getattr(got, field) == getattr(want, field) == value
    model = build_model(got, device="cpu")
    if field == "remat":
        assert model.enc_d1.remat and model.precision == "fp32"
    else:
        assert model.precision == "bf16"
    agg = train_sr_dr.main(base + flag)
    assert all(np.isfinite(v["mean"]) for v in agg.values())
    assert 0.0 < agg["mrr_d1"]["mean"] <= 1.0
    if field == "matmul_precision":
        cfg = config.parse_cli(base[:-4] + ["--matmul_precision", "highest"], is_dr=True)
        assert cfg.model.matmul_precision == "highest"
        assert build_model(cfg.model, device="cpu").precision == "fp32"
        cfg.fast_train = cfg.fast_eval = cfg.checkpoint = False
        assert 0.0 < loop.run(cfg, device="cpu")["mrr_d1"]["mean"] <= 1.0


def test_run_serves_a_config_as_it_is(tmp_path, csv_root):
    """`run` takes the reference's defaults as they are: it trains on the
    fast loops and checkpoints (async, full payload) as the JAX package's
    `run` does; with `checkpoint` off it writes none."""
    cfg = config.parse_cli(TINY + ["--data_root", csv_root, "-md", str(tmp_path),
                                   "--kernels", "torch"], is_dr=True)
    assert cfg.fast_train and cfg.fast_eval and cfg.checkpoint and cfg.checkpoint_async
    agg = loop.run(cfg, device="cpu")
    assert 0.0 < agg["mrr_d1"]["mean"] <= 1.0
    _assert_default_checkpoint(tmp_path, (tmp_path / "log_all.txt").read_text())
    cfg.checkpoint, cfg.model_dir = False, str(tmp_path / "off")
    assert loop.run(cfg, device="cpu")["mrr_d1"] == agg["mrr_d1"]
    assert not (tmp_path / "off" / "checkpoint").exists()


def test_evaluation_pass_over_the_csv_equals_the_jax_package_s(csv_root):
    """The test split packed by both packages is equal array by array; on
    identical weights and the negatives the JAX pass draws, the port's
    evaluation pass gives the same metrics (ranks are integers: equal; the
    loss within 1e-5)."""
    kw = dict(backbone="sasrec", emb_dim=16, hid_dim=8, seq_len=6, batch_size=16,
              is_itc=True, ts2=0.4, is_dr=True, sasrec_heads=2, comp_broadcast_quirk=False)
    jcfg = jax_config.ModelConfig(**kw, kernels="xla")
    path = config.DataConfig(dataset_type="toy", domain_type="a_b",
                             data_root=csv_root).test_csv()
    jds = jax_load_csv(path, 6, jcfg.pad_id)
    ds = load_dual_domain_csv(path, 6, jcfg.pad_id)
    for name, arr in jds.batch_arrays().items():
        np.testing.assert_array_equal(ds.batch_arrays()[name], arr, err_msg=name)
    np.testing.assert_array_equal(ds.pools, jds.pools)

    jmodel = jax_build_model(jcfg)
    key = jax.random.PRNGKey(0)
    sample = {k: jnp.asarray(v[:16]) for k, v in jds.batch_arrays().items()}
    sample["neg_samples"] = jnp.zeros((16, 1), jnp.int32)
    params = jmodel.init({"params": key, "dropout": key}, sample, train=False)["params"]
    jpools, jsizes = jnp.asarray(jds.pools), jnp.asarray(jds.pool_sizes)
    num_neg, eval_key = 9, jax.random.PRNGKey(7)
    want = jax_loop.evaluate(
        jax_steps.make_eval_step(jmodel, num_neg), params,
        JaxBatchIterator(jds, 16, shuffle=False, drop_last=True), jpools, jsizes,
        eval_key, overlap_eval=True)

    model = build_model(config.ModelConfig(**kw), device="cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    eval_step = steps.make_eval_step(model, num_neg)
    val_iter = BatchIterator(ds, 16, shuffle=False, drop_last=True)
    negs = [np.array(jax_sample_negatives(
        jax.random.fold_in(eval_key, i), jpools, jsizes, jnp.asarray(b["domain_id"]),
        jnp.asarray(b["reject"]), num_neg, jnp.asarray(b["reject_counts"])))
        for i, b in enumerate(val_iter)]
    assert len(negs) == 2
    calls = iter(negs)
    got = loop.evaluate(
        lambda batch, pools, sizes, k: eval_step(batch, pools, sizes, k, neg=next(calls)),
        val_iter, torch.as_tensor(ds.pools), torch.as_tensor(ds.pool_sizes), 0,
        overlap_eval=True)
    assert got.keys() == want.keys()
    for k in want:
        if k == "val_loss":
            assert abs(got[k] - want[k]) <= 1e-5
        else:
            assert got[k] == pytest.approx(want[k], abs=1e-12), k
