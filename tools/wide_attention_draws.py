#!/usr/bin/env python3
"""Draws behind chip_smoke.py's holding the fp32 long attention pair at
head width 256 to the dh=128 tolerances (`bwd_atol`, LONG_STATS_ATOL): the
pair at configuration (c)'s shape (B=256, 4 heads of 256, T=300), key
padding (batch row 0 fully masked) and causal, rates 0 and 0.1, over several
draws. Each draw prints one JSON line: the forward's output and row
statistics against the plain version's, the backward's |kernel - plain| -
RTOL |plain| (`atol_needed`, per T=150 as `bwd_atol` scales it), and the
kernel's and the plain fp32 version's largest errors against the plain
version in fp64 on 32 rows.

    python3 tools/wide_attention_draws.py [--draws 4]

Needs one CUDA card and nvcc (the kernels are built from the repository's
sources); imports nothing of JAX."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--draws", type=int, default=4)
    args = parser.parse_args()
    import torch

    import chip_smoke as cs
    from amid_tpu_torch.ops import attention as attention_ops
    from amid_tpu_torch.ops.attention import (
        attention_bwd_plain, attention_fwd_stats_plain, attention_fwd_stats_streamed_plain,
    )

    if not torch.cuda.is_available():
        print("wide_attention_draws: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    b, heads, dh, t, ob = cs.WIDE_B, cs.WIDE_HEADS, cs.WIDE_DH, cs.WIDE_T, cs.ORACLE_ROWS
    d = heads * dh
    for draw in range(args.draws):
        for kind in ("keypad", "causal"):
            for rate in (0.0, 0.1):
                q, k, v, dout = (torch.randn(b, t, d, device="cuda", generator=gen)
                                 for _ in range(4))
                bias = (torch.triu(torch.full((t, t), -1e9, device="cuda"), 1)[None, None]
                        if kind == "causal" else cs.keypad_bias(torch, gen, b, t))
                seed = torch.tensor([draw], dtype=torch.int64, device="cuda")
                with torch.no_grad():
                    stats = attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, True,
                                                          "long")
                    want = attention_fwd_stats_streamed_plain(q, k, v, bias, seed, heads, rate)
                    rec = {"draw": draw, "bias": kind, "rate": rate,
                           "out": (stats[0] - want[0]).abs().max().item(),
                           "row_max": (stats[1] - want[1]).abs().max().item(),
                           "row_inv_sum": (stats[2] - want[2]).abs().max().item()}
                    res = attention_fwd_stats_plain(q, k, v, bias, seed, heads, rate)
                    got = attention_ops._launch_backward(q, k, v, bias, *res, dout, seed, heads,
                                                         rate, "long")
                    plain = attention_bwd_plain(q, k, v, bias, *res, dout, seed, heads, rate)
                    rec["atol_needed_per_T150"] = max(
                        ((g - w).abs() - cs.RTOL * w.abs()).max().item()
                        for g, w in zip(got, plain)) / max(1.0, t / 150)
                    wide = [x[:ob].double() for x in (q, k, v, bias)]
                    exact = attention_bwd_plain(*wide, *attention_fwd_stats_plain(
                        *wide, seed, heads, rate), dout[:ob].double(), seed, heads, rate)
                    live = ~(bias[:ob] <= -1e8).reshape(bias[:ob].shape[0], -1).all(dim=1)
                    live = live.expand(ob) if live.numel() == 1 else live
                    for which, grads in (("plain", plain), ("kernel", got)):
                        rec[f"{which}_vs_fp64"] = max(
                            (g[:ob][live].double() - w[live]).abs().max().item()
                            for g, w in zip(grads, exact))
                print(json.dumps(rec), flush=True)
                del q, k, v, dout, stats, want, res, got, plain, exact
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
