#!/usr/bin/env python3
"""Times K1's one-head attention pair in the bf16-operand mode of one tree of
this repository on one CUDA card, beside `scaled_dot_product_attention` on
bf16 q, k, v (a yardstick the port never calls).

    python3 tools/attention_bf16_compare.py [--tree DIR] [--steps] [--tag NAME]

`--tree` names the checkout whose `amid_tpu_torch` and `chip_smoke.py` are
imported (by default the one holding this script), so one call can time two
trees in turns (parent, change, change, parent) on one card. Each case is the
one-head path asked for by name (`path='sweep'`, `bf16=True`), timed as
`chip_smoke.py` times a kernel: `device_ms` is the mean over the replay of a
CUDA graph of 20 captured calls (the device alone); SDPA's `library_device_ms`
the same, its backward as forward + backward less the forward. `bound_ms` is
`chip_smoke.attention_bound` / `attention_bwd_bound` at the bf16 peak. The
cases are every one-head bf16 case of `chip_smoke.py`'s phases 10 and 12:
SASRec's shapes (B=256, 8 heads of 16, causal) at T=150 and T=20, rates 0
and 0.5; heads of 12 (8 of them: configuration (b)), 24, 48 and 128 (4),
causal and key padding, rates 0 and 0.1, T=150 (the backward at dh=128
T=64), B=256 at dh=12 causal and 64 elsewhere; both directions. With
`--steps` also the replayed phase-A
step of `--bf16` SASRec (`chip_smoke.replayed_phase_a`): T=150 dense
pairwise, T=20 lazy, and configuration (b) (`--emb_dim 96`) at T=150 dense.
Prints one JSON line a case or step, tagged with `--tag`, and needs the card.

`--occupancy` prints instead the blocks an SM of the one-head bf16 pair at
dh=16, T=150 and T=20, by the occupancy rules of sm_90 (OCCUPANCY) from
ptxas's registers of the instance (`_build.ptxas_report`), the kernel's own
shared memory (`attention_*_smem_bytes`) and its warps a block.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

# (name, B, T, heads, D, bias, rate): chip_smoke.py's phase-10 one-head
# cases (SASRec's shapes, dh=16) and phase 12's (`width_kernel_phase`: the
# widths of WIDTH_HEADS, B=256 at configuration (b)'s dh=12 causal, else 64;
# the backward at T=64 at dh=128)
FWD_CASES = [(f"fwd_causal_T{t}_dh16_rate{r}", 256, t, 8, 128, "causal", r)
             for t in (150, 20) for r in (0.0, 0.5)]
BWD_CASES = [(f"bwd_causal_T{t}_dh16_rate{r}", 256, t, 8, 128, "causal", r)
             for t in (150, 20) for r in (0.0, 0.5)]
for _dh, _heads in ((12, 8), (24, 4), (48, 4), (128, 4)):
    for _kind in ("causal", "keypad"):
        for _r in (0.0, 0.1):
            _b = 256 if (_dh, _kind) == (12, "causal") else 64
            FWD_CASES.append((f"fwd_{_kind}_T150_dh{_dh}_B{_b}_rate{_r}", _b, 150, _heads,
                              _dh * _heads, _kind, _r))
            _t = 64 if _dh == 128 else 150
            BWD_CASES.append((f"bwd_{_kind}_T{_t}_dh{_dh}_B{_b}_rate{_r}", _b, _t, _heads,
                              _dh * _heads, _kind, _r))
# sm_90's occupancy rules: blocks, warps, 32-bit registers and shared bytes an
# SM; registers are allotted a warp at a time in units of 256 from each of
# the 4 sub-partitions' 16,384, shared memory a block at a time with 1 KB
# reserved per block (CUDA programming guide, compute capability 9.0)
OCCUPANCY = dict(blocks=32, warps=64, sub_regs=16384, reg_unit=256, smem=233472,
                 smem_reserved=1024)


def blocks_per_sm(regs: int, warps: int, smem: int) -> tuple[int, str]:
    """The blocks of `warps` warps an SM holds at `regs` registers a thread
    and `smem` bytes of shared memory a block, and what limits them."""
    o = OCCUPANCY
    warp_regs = -(-regs * 32 // o["reg_unit"]) * o["reg_unit"]
    limits = {"blocks": o["blocks"], "warps": o["warps"] // warps,
              "registers": 4 * (o["sub_regs"] // warp_regs) // warps,
              "shared memory": o["smem"] // (smem + o["smem_reserved"])}
    which = min(limits, key=limits.get)
    return limits[which], which


STEP_CONFIGS = [  # (name, ModelConfig overrides of chip_smoke.FLAGSHIP, lazy table Adam)
    ("bf16_T150_dense_pairwise", dict(seq_len=150, comp_broadcast_quirk=False), False),
    ("bf16_T20_lazy", dict(seq_len=20), True),
    ("bf16_emb96_T150_dense", dict(seq_len=150, emb_dim=96), False),
]


def main() -> int:
    args = argparse.ArgumentParser()
    args.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    args.add_argument("--steps", action="store_true")
    args.add_argument("--tag", default="")
    args.add_argument("--occupancy", action="store_true")
    a = args.parse_args()
    sys.path.insert(0, str(Path(a.tree).resolve()))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("attention_bf16_compare: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from amid_tpu_torch.ops import attention as A
    from amid_tpu_torch.ops import _build

    _build.build(A._LIBRARIES)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"tag": a.tag, "tree": a.tree, "card": card.strip()}), flush=True)
    if a.occupancy:
        import ctypes
        import re

        for lib, fn in (("attention_fwd_bf16", "attention_fwd_smem_bytes"),
                        ("attention_bwd_bf16", "attention_bwd_smem_bytes")):
            _, rows, _ = _build.ptxas_report(lib)
            regs = next(r for k, r, _ in rows if re.search(r"ILi16ELb0E", k))
            smem = _build.bind(getattr(_build.load(lib), fn), [ctypes.c_int] * 2,
                               ctypes.c_size_t)
            for t in (150, 20):
                tiles = -(-t // 16)
                rounds = -(-tiles // 8)
                warps = -(-tiles // rounds)
                n, why = blocks_per_sm(regs, warps, smem(t, 16))
                print(json.dumps({"tag": a.tag, "kernel": lib, "dh": 16, "T": t,
                                  "registers": regs, "warps": warps,
                                  "smem_bytes": smem(t, 16), "blocks_per_sm": n,
                                  "limited_by": why}), flush=True)
        return 0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)

    def device_ms(fn):  # one eager call first: a library call allocates its workspace then
        fn()
        torch.cuda.synchronize()
        return cs.graph_ms(torch, fn)

    def inputs(b, t, heads, d, kind, n):
        xs = [torch.randn(b, t, d, device="cuda", generator=gen) for _ in range(n)]
        bias = (torch.triu(torch.full((t, t), -1e9, device="cuda"), diagonal=1)[None, None]
                if kind == "causal" else cs.keypad_bias(torch, gen, b, t))
        return xs, bias

    def split(x, heads):
        b, t, d = x.shape
        return x.view(b, t, heads, d // heads).transpose(1, 2).to(torch.bfloat16)

    with torch.no_grad():
        for name, b, t, heads, d, kind, rate in FWD_CASES:
            (q, k, v), bias = inputs(b, t, heads, d, kind, 3)
            seed = torch.tensor([7], dtype=torch.int64, device="cuda")
            ms = device_ms(lambda: A._launch_forward(q, k, v, bias, seed, heads, rate, False,
                                                     "sweep", bf16=True))
            qh, kh, vh = (split(x, heads) for x in (q, k, v))
            mask = bias.to(torch.bfloat16)
            lib = device_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, dropout_p=rate))
            bound = cs.attention_bound(b, t, d, heads, bias.numel(), cs.BF16_TENSOR_FLOPS)
            print(json.dumps({"tag": a.tag, "case": name, "device_ms": ms,
                              "library_device_ms": lib, "bound_ms": bound[0]}), flush=True)
            del q, k, v, qh, kh, vh, mask
    for name, b, t, heads, d, kind, rate in BWD_CASES:
        (q, k, v, dout), bias = inputs(b, t, heads, d, kind, 4)
        seed = torch.tensor([7], dtype=torch.int64, device="cuda")
        with torch.no_grad():
            res = A.attention_fwd_stats_plain(q, k, v, bias, seed, heads, rate, True)
            ms = device_ms(lambda: A._launch_backward(
                q, k, v, bias, *res, dout, seed, heads, rate, "sweep", bf16=True))
        leaves = [split(x, heads).detach().requires_grad_() for x in (q, k, v)]
        mask, g16 = bias.to(torch.bfloat16), split(dout, heads)

        def sdpa():
            return F.scaled_dot_product_attention(*leaves, attn_mask=mask, dropout_p=rate)

        both = device_ms(lambda: torch.autograd.grad(sdpa(), leaves, g16))
        with torch.no_grad():
            fwd_only = device_ms(sdpa)
        bound = cs.attention_bwd_bound(b, t, d, heads, bias.numel(), cs.BF16_TENSOR_FLOPS)
        print(json.dumps({"tag": a.tag, "case": name, "device_ms": ms,
                          "library_device_ms": both - fwd_only, "bound_ms": bound[0]}),
              flush=True)
        del q, k, v, dout, res, leaves
    torch.cuda.empty_cache()
    if a.steps:
        from amid_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
        from amid_tpu_torch.data.synthetic import synth_packed

        rng = np.random.default_rng(20)
        for name, kw, lazy in STEP_CONFIGS:
            cfg = ModelConfig(**{**cs.FLAGSHIP, **kw, "use_bf16": True})
            tcfg = TrainConfig(epochs=1, seeds=1, model_dir="", lazy_table_adam=lazy,
                               nan_policy="halt", checkpoint=False, model=cfg,
                               data=DataConfig(neg_nums=999))
            rec = cs.replayed_phase_a(torch, cfg, tcfg, synth_packed(cfg, rng, cs.TRAIN_ROWS))
            print(json.dumps({"tag": a.tag, "step": name,
                              **{k: rec[k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                                     "device_idle_share")}}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
