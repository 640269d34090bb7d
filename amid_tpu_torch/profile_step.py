"""Where a training step's time goes on the card: a `torch.profiler` trace of
the DR trainer's steps at the full width of the `run.sh` model.

    python -m amid_tpu_torch.profile_step --seq_len 20 --lazy
    python -m amid_tpu_torch.profile_step --seq_len 150
    python -m amid_tpu_torch.profile_step --seq_len 150 --pairwise

Builds the model (SASRec, InterComp ts2=0.4, DR heads, emb 128, hid 32, batch
256, 2 blocks, 8 heads, the 894,820-row table, random weights from a seed; with
`--pairwise` in the pairwise mode, whose gates come from the max-affinity
kernels) and a synthetic packed dataset (`data/synthetic.py`), then for the phase-A step,
the phase-B step and the evaluation batch (999 negatives):

* times `--steps` steps by the host clock, synchronised at both ends (no
  profiler attached): wall ms per step;
* traces the same number of steps with `torch.profiler` and sums the device
  time of every kernel: device ms per step, kernel launches per step, the
  device's idle share (1 - device time / wall time) and the kernels that take
  most of the device time.

Prints one JSON object per step kind and, first, the card's name and power
limit. Needs one CUDA card; exits non-zero if the trace holds no device time.
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
from amid_tpu_torch.train.loop import _device_pools, _to_device
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
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq_len", type=int, default=20)
    ap.add_argument("--lazy", action="store_true", help="lazy table Adam (default: dense)")
    ap.add_argument("--pairwise", action="store_true",
                    help="comp_broadcast_quirk=False (default: the broadcast-quirk mode)")
    ap.add_argument("--steps", type=int, default=10)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)

    cfg = ModelConfig(backbone="sasrec", emb_dim=128, hid_dim=32, batch_size=256,
                      seq_len=a.seq_len, is_itc=True, ts2=0.4, is_dr=True,
                      sasrec_blocks=2, sasrec_heads=8, comp_broadcast_quirk=not a.pairwise)
    tcfg = TrainConfig(model=cfg, data=DataConfig(neg_nums=999), lazy_table_adam=a.lazy)
    ds = synth_packed(cfg, np.random.default_rng(0), ROWS)
    model = build_model(cfg, seed=0)
    tx, tx2 = Adam(tcfg.lr), Adam(tcfg.lr * tcfg.lr2)
    if a.lazy:
        state = lazy.init_lazy_state(dict(model.named_parameters()), tx, tx2)
        step_a = lazy.make_lazy_train_step(model, tx, dr_e_w=tcfg.dr_e_w)
        step_b = lazy.make_lazy_dr_r_step(model, tx2)
    else:
        state = steps.init_state(model, tx, tx2)
        step_a = steps.make_train_step(model, tx, dr_e_w=tcfg.dr_e_w)
        step_b = steps.make_dr_r_step(model, tx2)
    eval_step = steps.make_eval_step(model, tcfg.data.neg_nums)
    batches = [_to_device(b, "cuda") for b in BatchIterator(ds, cfg.batch_size, False)]
    pools = _device_pools(ds, "cuda")
    counter = iter(range(10**9))

    def next_batch():
        return batches[next(counter) % len(batches)]

    kinds = {
        "phase_a": lambda: step_a(state, next_batch(), *pools, next(counter)),
        "phase_b": lambda: step_b(state, next_batch(), *pools, next(counter)),
        "eval_batch": lambda: eval_step(next_batch(), *pools, next(counter)),
    }
    for name, fn in kinds.items():
        for _ in range(3):
            fn()
        wall = _wall_ms(fn, a.steps)
        device, launches, ranked = _trace(fn, a.steps, TOP)
        if device <= 0.0:
            print(f"profile_step: the trace of {name} holds no device time", file=sys.stderr)
            return 1
        print(json.dumps({
            "step": name, "seq_len": a.seq_len, "optimizer": "lazy" if a.lazy else "dense",
            "pairwise": a.pairwise,
            "wall_ms_per_step": wall, "device_ms_per_step": device,
            "device_idle_share": max(0.0, 1.0 - device / wall),
            "kernel_launches_per_step": launches, "top_kernels": ranked,
            "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
