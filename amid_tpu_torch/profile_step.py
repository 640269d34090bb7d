"""Where a training step's time goes on the card: a `torch.profiler` trace of
the DR trainer's steps at the full width of the `run.sh` model.

    python -m amid_tpu_torch.profile_step --seq_len 20 --lazy
    python -m amid_tpu_torch.profile_step --seq_len 150
    python -m amid_tpu_torch.profile_step --seq_len 150 --pairwise
    python -m amid_tpu_torch.profile_step --seq_len 20 --lazy --fast
    python -m amid_tpu_torch.profile_step --seq_len 150 --model bert4rec --fast
    python -m amid_tpu_torch.profile_step --seq_len 150 --model bert4rec --emb_dim 1024 \
        --pairwise --fast

Builds the model (SASRec, InterComp ts2=0.4, DR heads, emb 128, hid 32, batch
256, 2 blocks, 8 heads, the 894,820-row table, random weights from a seed; with
`--model bert4rec` or `gru4rec` that backbone at the same width, BERT4Rec with
2 blocks of 4 heads, FFN 512, dropout 0.1; with `--inc` InnerComp too; with
`--pairwise` in the pairwise mode, whose gates come from the max-affinity
kernels; `--emb_dim` another width: 1024 with BERT4Rec is configuration (c),
4 heads of 256 on the long attention paths) and a synthetic packed dataset
(`data/synthetic.py`), then for the phase-A step,
the phase-B step and the evaluation batch (999 negatives):

* times `--steps` steps by the host clock, synchronised at both ends (no
  profiler attached): wall ms per step;
* traces the same number of steps with `torch.profiler` and sums the device
  time of every kernel: device ms per step, kernel launches per step, the
  device's idle share (1 - device time / wall time) and the kernels that take
  most of the device time.

Without `--fast` each step is the eager step function, as the per-step loop
calls it. With `--fast` the steps are those of the fast loops: the dataset
resident on the device, each step kind a CUDA graph replayed by
`steps.make_resident_chunk_runner` (a chunk of 10 steps a call) and
`steps.make_scanned_eval` (a pass of 10 batches a call), after the eager step
and the capture that the first calls make.

Prints one JSON object per step kind and, first, the card's name and power
limit. Needs one CUDA card; exits non-zero if the trace holds no device time.
`step_kinds` and `measure` serve `chip_smoke.py` too.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from amid_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from amid_tpu_torch.data.loader import BatchIterator
from amid_tpu_torch.data.synthetic import synth_packed
from amid_tpu_torch.models.amid import build_model
from amid_tpu_torch.train import lazy, steps
from amid_tpu_torch.train.loop import STEP_KEYS, _device_pools, _resident, _to_device
from amid_tpu_torch.train.optim import Adam


ROWS = 2560  # synthetic dataset rows: 10 batches to cycle over
TOP = 40  # kernels listed per step kind: enough to show each kernel of the port


def _wall_ms(fn, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _trace(fn, n: int, top: int):
    """Device ms, kernel launches and the `top` kernels per call of `fn`
    over `n` traced calls. Only the device's activity is recorded: nothing
    here reads the host's operator events, whose processing dominated the
    trace of a step with thousands of launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = evt.cuda_time_total
        by_name[evt.name][0] += us
        by_name[evt.name][1] += 1
    device_us = sum(v[0] for v in by_name.values())
    launches = sum(v[1] for v in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return device_us / 1e3 / n, launches / n, [
        {"kernel": name[:90], "ms_per_step": us / 1e3 / n, "per_step": cnt / n}
        for name, (us, cnt) in ranked]


def step_kinds(cfg: ModelConfig, tcfg: TrainConfig, ds, fast: bool, pool=None,
               mesh=None) -> dict:
    """name -> (fn, steps a call) for phase A, phase B and the evaluation
    batch of a fresh model on `ds`: eager steps cycling over the batches, or
    with `fast` the fast loops' replays over the resident dataset (graphs in
    `pool`, which the caller closes). Phase A is `run_seed`'s: with C2DSR
    (`cfg.is_c2dsr`, dense Adam) it adds `tcfg.cl_w` times the infomax loss
    of the views. With `mesh` (`parallel/mesh.py`) the table is cut to this
    rank's rows and every call runs the gspmd steps on it, collectives
    included (and captured, with `fast`)."""
    kinds = _step_kinds(cfg, tcfg, ds, fast, pool, mesh)
    if mesh is None:
        return kinds
    from amid_tpu_torch.parallel.context import spmd

    def on_mesh(fn):
        def call():
            with spmd(mesh.axes("gspmd")):
                return fn()
        return call

    return {k: (on_mesh(fn), n) for k, (fn, n) in kinds.items()}


def _step_kinds(cfg, tcfg, ds, fast, pool, mesh):
    model = build_model(cfg, seed=0)
    if mesh is not None:
        from amid_tpu_torch.parallel.distributed import shard_params_

        shard_params_(model, mesh)
    tx, tx2 = Adam(tcfg.lr), Adam(tcfg.lr * tcfg.lr2)
    if tcfg.lazy_table_adam:
        state = lazy.init_lazy_state(dict(model.named_parameters()), tx, tx2)
        step_a = lazy.make_lazy_train_step(model, tx, dr_e_w=tcfg.dr_e_w)
        step_b = lazy.make_lazy_dr_r_step(model, tx2)
    else:
        state = steps.init_state(model, tx, tx2)
        step_a = steps.make_train_step(model, tx, dr_e_w=tcfg.dr_e_w,
                                       c2dsr_w=tcfg.cl_w if cfg.is_c2dsr else None)
        step_b = steps.make_dr_r_step(model, tx2)
    pools = _device_pools(ds, "cuda")
    bs = cfg.batch_size
    counter = iter(range(10**9))
    if not fast:
        eval_step = steps.make_eval_step(model, tcfg.data.neg_nums)
        batches = [_to_device(b, "cuda") for b in BatchIterator(ds, bs, False)]

        def next_batch():
            return batches[next(counter) % len(batches)]

        return {
            "phase_a": (lambda: step_a(state, next_batch(), *pools, next(counter)), 1),
            "phase_b": (lambda: step_b(state, next_batch(), *pools, next(counter)), 1),
            "eval_batch": (lambda: eval_step(next_batch(), *pools, next(counter)), 1),
        }
    nb = len(ds) // bs
    arrays = _resident(ds.batch_arrays(), "cuda")
    perm = torch.arange(nb * bs, dtype=torch.int32, device="cuda")
    run_a = steps.make_resident_chunk_runner(step_a, bs, pool)
    run_b = steps.make_resident_chunk_runner(step_b, bs, pool)
    eval_all = steps.make_scanned_eval(model, tcfg.data.neg_nums, pool)
    stacked = {k: v.view(nb, bs, *v.shape[1:]) for k, v in arrays.items() if k in STEP_KEYS}

    def chunk(run):
        def call():
            k = next(counter) * nb
            run(state, arrays, perm, *pools, 0, range(k, k + nb), range(nb))
        return call

    return {"phase_a": (chunk(run_a), nb), "phase_b": (chunk(run_b), nb),
            "eval_batch": (lambda: eval_all(stacked, *pools, next(counter)), nb)}


def measure(fn, per_call: int, calls: int, top: int = TOP) -> dict:
    """Wall ms, device ms, launches and top kernels per step of `fn`, which
    takes `per_call` steps a call: at least 3 steps of warm-up (one call of a
    replay chunk: its eager step, the capture and the replays), then `calls`
    calls timed by the host clock and `calls` traced."""
    for _ in range(-(-3 // per_call)):
        fn()
    wall = _wall_ms(fn, calls) / per_call
    device, launches, ranked = _trace(fn, calls, top)
    return {"wall_ms_per_step": wall, "device_ms_per_step": device / per_call,
            "device_idle_share": max(0.0, 1.0 - device / per_call / wall),
            "kernel_launches_per_step": launches / per_call,
            "top_kernels": [{**r, "ms_per_step": r["ms_per_step"] / per_call,
                             "per_step": r["per_step"] / per_call} for r in ranked]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq_len", type=int, default=20)
    ap.add_argument("--lazy", action="store_true", help="lazy table Adam (default: dense)")
    ap.add_argument("--pairwise", action="store_true",
                    help="comp_broadcast_quirk=False (default: the broadcast-quirk mode)")
    ap.add_argument("--fast", action="store_true",
                    help="trace the fast loops' replayed steps (default: eager steps)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--model", default="sasrec", choices=("sasrec", "bert4rec", "gru4rec"))
    ap.add_argument("--inc", action="store_true", help="InnerComp on (ts1=0.5)")
    ap.add_argument("--emb_dim", type=int, default=128,
                    help="the item embedding width (1024 with --model bert4rec: "
                         "configuration (c), 4 heads of 256)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)

    cfg = ModelConfig(backbone=a.model, emb_dim=a.emb_dim, hid_dim=32, batch_size=256,
                      seq_len=a.seq_len, is_inc=a.inc, is_itc=True, ts2=0.4, is_dr=True,
                      sasrec_blocks=2, sasrec_heads=8, comp_broadcast_quirk=not a.pairwise)
    tcfg = TrainConfig(model=cfg, data=DataConfig(neg_nums=999), lazy_table_adam=a.lazy)
    ds = synth_packed(cfg, np.random.default_rng(0), ROWS)
    pool = None
    if a.fast:
        from amid_tpu_torch.train.graphs import GraphPool

        pool = GraphPool("cuda")
    try:
        for name, (fn, per_call) in step_kinds(cfg, tcfg, ds, a.fast, pool).items():
            calls = -(-a.steps // per_call)
            rec = measure(fn, per_call, calls)
            if rec["device_ms_per_step"] <= 0.0:
                print(f"profile_step: the trace of {name} holds no device time",
                      file=sys.stderr)
                return 1
            print(json.dumps({
                "step": name, "model": a.model, "emb_dim": a.emb_dim, "inc": a.inc,
                "seq_len": a.seq_len,
                "optimizer": "lazy" if a.lazy else "dense", "pairwise": a.pairwise,
                "loop": "fast (CUDA graph replays)" if a.fast else "per step (eager)",
                "steps": calls * per_call, **rec,
                "device": torch.cuda.get_device_name(0)}), flush=True)
    finally:
        if pool is not None:
            pool.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
