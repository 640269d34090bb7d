"""Mesh training across the cards of one host, over NCCL: `run_seed` on a
`data x model` mesh of the world's ranks against the same run off the mesh,
and the replayed phase-A step on and off the mesh with the collectives'
share of its device time.

    torchrun --nproc_per_node 4 -m amid_tpu_torch.mesh_check

One rank a card. Rank 0 builds the kernels while the others wait. The
run.sh model at full width (SASRec, InterComp ts2=0.4, DR heads, emb 128,
hid 32, batch 256, 2 blocks of 8 heads, the 894,820-row table; BERT4Rec
with 2 blocks of 4 heads), random weights and synthetic data from a seed
(1,024 / 512 / 1,024 rows: 4 + 4 steps and 2 evaluation batches of one
epoch of the DR schedule). Each case runs off the mesh on every rank's own
card (the same run everywhere), then on the mesh:

* gspmd at W x 1 (T=150, dense Adam, pairwise: the peer banks gathered
  across the cards, K6 on each rank's rows against the global bank) and
  BERT4Rec T=150 at W x 1 (both long K1 paths at a row offset);
* gspmd at 2 x W/2, T=20 with the lazy table Adam (the table's rows over
  `model`, the unique rows gathered by the sharded lookup);
* gspmd at 1 x W, T=150 dense (the table and its moments over W cards);
* shard_map at 2 x W/2, T=150 dense (per-shard streams: trains, and is not
  the single process's function).

A gspmd case's metrics must lie within `--tol` (1e-5) of the run off the
mesh: it computes the single-process function of the global batch, in
another order of sums. Then the replayed phase-A step (a chunk of 10; T=150
dense pairwise and T=20 lazy) off the mesh and on W x 1 (`phase_a_timing`,
which `chip_smoke.py`'s phase 11 reads too): wall and device ms, the NCCL
kernels' and the copies' count and device ms a step from a `torch.profiler`
trace, peak memory. Rank 0 prints the card's name and power limit, one JSON
line a case and a timing, and last `{"ok": ...}`; the exit code is 1 if a
gspmd case parts from its run off the mesh by more than `--tol`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from amid_tpu_torch.config import DataConfig, MeshConfig, ModelConfig, TrainConfig
from amid_tpu_torch.data.synthetic import synth_packed
from amid_tpu_torch.parallel.distributed import initialize_distributed
from amid_tpu_torch.parallel.mesh import make_mesh
from amid_tpu_torch.train.loop import run_seed

ROWS = (1024, 512, 1024)  # train, val, DR
FLAGSHIP = dict(backbone="sasrec", emb_dim=128, hid_dim=32, batch_size=256, is_itc=True,
                ts2=0.4, is_dr=True, sasrec_blocks=2, sasrec_heads=8)
BERT4REC = dict(backbone="bert4rec", bert_blocks=2, bert_heads=4, bert_ff_dim=512,
                bert_dropout=0.1)


def _emit(obj) -> None:
    if dist.get_rank() == 0:
        print(json.dumps(obj), flush=True)


def _build_kernels() -> None:
    from amid_tpu_torch.ops import _build

    sources = sorted({p.stem for p in _build.CSRC.glob("*.cu")} | set(_build.VARIANTS))
    if dist.get_rank() == 0:
        _build.build(sources)
    dist.barrier()


def _cases(world: int) -> dict:
    """label -> (model fields, lazy Adam, impl, data axis, model axis)."""
    half = max(1, world // 2)
    return {
        f"gspmd_{world}x1_T150_dense_pairwise": (
            {"seq_len": 150, "comp_broadcast_quirk": False}, False, "gspmd", world, 1),
        f"gspmd_{world}x1_bert4rec_T150": ({**BERT4REC, "seq_len": 150}, False, "gspmd", world, 1),
        f"gspmd_2x{half}_T20_lazy": ({"seq_len": 20}, True, "gspmd", world // half, half),
        f"gspmd_1x{world}_T150_dense": ({"seq_len": 150}, False, "gspmd", 1, world),
        f"shard_map_2x{half}_T150_dense": ({"seq_len": 150}, False, "shard_map", world // half,
                                          half),
    }


def _run(tcfg, data, work) -> tuple[dict, float, float]:
    torch.cuda.reset_peak_memory_stats()
    tcfg = dataclasses.replace(tcfg, model_dir=work)
    t0 = time.perf_counter()
    best = run_seed(tcfg, 0, *data)
    torch.cuda.synchronize()
    return best, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9


def phase_a_timing(cfg, tcfg, ds, mesh) -> dict:
    """The replayed phase-A step (a chunk of 10) of a fresh model on `ds`,
    on `mesh` or off it (None): `profile_step.measure`'s wall and device
    ms, then the NCCL kernels' and the copies' count and device ms a step
    from the trace, and the peak memory. The model and its graphs are freed
    on return."""
    from amid_tpu_torch.profile_step import measure, step_kinds
    from amid_tpu_torch.train.graphs import GraphPool

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pool = GraphPool("cuda")
    try:
        fn, per_call = step_kinds(cfg, tcfg, ds, True, pool, mesh)["phase_a"]
        rec = measure(fn, per_call, 1, top=1000)
    finally:
        pool.close()
    top = rec.pop("top_kernels")
    for name, match in (("nccl", lambda k: "nccl" in k.lower()),
                        ("copies", lambda k: k.startswith(("Memcpy", "Memset")))):
        hits = [k for k in top if match(k["kernel"])]
        rec[f"{name}_per_step"] = sum(k["per_step"] for k in hits)
        rec[f"{name}_device_ms_per_step"] = sum(k["ms_per_step"] for k in hits)
        rec[f"{name}_kernels"] = sorted({k["kernel"] for k in hits})
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tol", type=float, default=1e-5)
    a = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed()  # torchrun's environment; NCCL, one card a rank
    if not dist.is_initialized():
        print("mesh_check: run it under torchrun (no torch.distributed world)",
              file=sys.stderr)
        return 2
    world = dist.get_world_size()
    if dist.get_rank() == 0:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)
    _emit({"world": world, "torch": torch.__version__, "nccl": list(torch.cuda.nccl.version()),
           "device": torch.cuda.get_device_name()})
    _build_kernels()
    ok = True
    rng = np.random.default_rng(0)
    for label, (fields, lazy, impl, d, m) in _cases(world).items():
        cfg = ModelConfig(**{**FLAGSHIP, **fields})
        data = [synth_packed(cfg, rng, n) for n in ROWS]
        base = TrainConfig(epochs=1, seeds=1, lazy_table_adam=lazy, nan_policy="halt",
                           checkpoint=False, model=cfg, data=DataConfig(neg_nums=999))
        mesh_cfg = dataclasses.replace(base, use_mesh=True, mesh_impl=impl,
                                       mesh=MeshConfig(data_axis=d, model_axis=m))
        work = tempfile.mkdtemp(prefix="mesh_check_")
        try:
            off, off_s, off_gb = _run(base, data, work)
            on, on_s, on_gb = _run(mesh_cfg, data, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        keys = [k for k in off if k.startswith(("hit_", "ndcg_", "mrr"))]
        diff = max(abs(on[k] - off[k]) for k in keys)
        same = [None] * world
        dist.all_gather_object(same, {k: on[k] for k in keys})
        every_rank_same = all(s == same[0] for s in same)
        if impl == "gspmd" and not diff <= a.tol:
            ok = False
        if not every_rank_same or not all(np.isfinite(on[k]) for k in keys):
            ok = False
        _emit({"mesh_check_run": {
            "config": label, "impl": impl, "mesh": [d, m], "lazy_adam": lazy,
            "max_metric_diff": diff, "bit_equal": diff == 0.0,
            "every_rank_same": every_rank_same, "mrr_d1": [off["mrr_d1"], on["mrr_d1"]],
            "seconds": [off_s, on_s], "peak_memory_gb": [off_gb, on_gb]}})
        torch.cuda.empty_cache()
    mesh = make_mesh(MeshConfig(data_axis=world, model_axis=1))
    for label, fields, lazy in (("T150_dense_pairwise",
                                 {"seq_len": 150, "comp_broadcast_quirk": False}, False),
                                ("T20_lazy", {"seq_len": 20}, True)):
        cfg = ModelConfig(**{**FLAGSHIP, **fields})
        tcfg = TrainConfig(model=cfg, data=DataConfig(neg_nums=999), lazy_table_adam=lazy)
        ds = synth_packed(cfg, np.random.default_rng(1), 2560)
        for where, m in (("off_mesh", None), (f"mesh_{world}x1", mesh)):
            _emit({"mesh_check_timing": {"config": label, "where": where,
                                         **phase_a_timing(cfg, tcfg, ds, m)}})
    _emit({"ok": ok, "world": world})
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
