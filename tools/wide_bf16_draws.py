#!/usr/bin/env python3
"""Draws behind chip_smoke.py's BF16_LIMITS for the bf16 kernels at the
widest shapes: K1's bf16 long pair at head width 256 ("bf16_long_dh256",
"bf16_bwd_long_dh256": configuration (d)'s attention, B=256, 4 heads of
256, T=300, key padding with batch row 0 fully masked and causal, rates 0
and 0.1) and K5's wide kernel in bf16 ("bf16_scoring_wide_C1000",
"bf16_scoring_wide_C2": B=256, D=1,024, H=64, both users a launch; three
times the draws, they are cheap). Each draw prints one JSON line of
`chip_smoke.Bf16Readings`' norms so far for a case: the bf16 build against
the fp64 oracle of its own rounding points, against the plain bf16
version, the plain version against the oracle of the JAX kernel's
rounding, and the fp32 build against the first (the control, which must
read far above the limit).

    python3 tools/wide_bf16_draws.py [--draws 3]

Needs one CUDA card and nvcc (the kernels are built from the repository's
sources); imports nothing of JAX."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--draws", type=int, default=3)
    args = parser.parse_args()
    import torch

    import chip_smoke as cs
    from amid_tpu_torch.ops import attention as attention_ops
    from amid_tpu_torch.ops.attention import (
        LONG_BF16_STAGE_KEYS, attention_bwd_plain, attention_fwd_stats_plain,
        attention_fwd_stats_streamed_plain,
    )
    from amid_tpu_torch.ops.scoring import scoring_head_pair, scoring_head_pair_plain

    if not torch.cuda.is_available():
        print("wide_bf16_draws: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"gpu": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()}), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    ob = cs.ORACLE_ROWS
    b, heads, dh, t = cs.WIDE_B, cs.WIDE_HEADS, cs.WIDE_DH, cs.WIDE_T
    d = heads * dh
    seed = torch.tensor([4242], dtype=torch.int64, device="cuda")
    for kind in ("keypad", "causal"):
        for rate in (0.0, 0.1):
            fwd, bwd = cs.Bf16Readings(), cs.Bf16Readings()
            for draw in range(args.draws):
                q, k, v, dout = (torch.randn(b, t, d, device="cuda", generator=gen)
                                 for _ in range(4))
                bias = (torch.triu(torch.full((t, t), -1e9, device="cuda"), 1)[None, None]
                        if kind == "causal" else cs.keypad_bias(torch, gen, b, t))
                rows = (q[:ob], k[:ob], v[:ob], bias[:ob], seed, heads, rate)
                with torch.no_grad():
                    def launch(bf16):
                        return attention_ops._launch_forward(q, k, v, bias, seed, heads, rate,
                                                             False, "long", bf16=bf16)[0]

                    fwd.draw([(launch(True), launch(False), attention_fwd_stats_streamed_plain(
                        q, k, v, bias, seed, heads, rate, LONG_BF16_STAGE_KEYS, True)[0],
                        cs.bf16_attention_kernel_oracle(torch, *rows, LONG_BF16_STAGE_KEYS),
                        cs.bf16_attention_oracle(torch, *rows))])
                    res = attention_fwd_stats_plain(q, k, v, bias, seed, heads, rate, True)

                    def grads(bf16):
                        return attention_ops._launch_backward(q, k, v, bias, *res, dout, seed,
                                                              heads, rate, "long", bf16=bf16)

                    oracle = cs.bf16_attention_bwd_oracle(torch, q[:ob], k[:ob], v[:ob],
                                                          bias[:ob], res[0][:ob], dout[:ob],
                                                          seed, heads, rate)
                    bwd.draw(list(zip(grads(True), grads(False), attention_bwd_plain(
                        q, k, v, bias, *res, dout, seed, heads, rate, True), oracle, oracle)))
                for name, r in (("fwd", fwd), ("bwd", bwd)):
                    print(json.dumps({"case": f"bf16_{name}_long_{kind}_T{t}_dh{dh}_rate{rate}",
                                      "draws": draw + 1, **r.r}), flush=True)
                del q, k, v, dout, res, oracle
                torch.cuda.empty_cache()

    width, hid = 1024, cs.WIDE_HID
    for c in (1000, 2):
        r = cs.Bf16Readings()
        for draw in range(3 * args.draws):
            def rand(*shape, scale=1.0):
                return torch.randn(*shape, device="cuda", generator=gen) * scale

            fc1 = rand(hid, 2 * width, scale=(2 * width) ** -0.5)
            params = (fc1[:, :width], fc1[:, width:], rand(hid, scale=0.1),
                      rand(1, hid, scale=hid ** -0.5), rand(1, scale=0.1))
            user, other, items = rand(b, width), rand(b, width), rand(b, c, width)
            with torch.no_grad():
                oracles = [cs.bf16_scoring_oracle(torch, u, items, *params) for u in (user, other)]
                r.draw(list(zip(scoring_head_pair(user, other, items, *params, bf16=True),
                                scoring_head_pair(user, other, items, *params),
                                scoring_head_pair_plain(user, other, items, *params, bf16=True),
                                oracles, oracles)))
            print(json.dumps({"case": f"bf16_scoring_wide_C{c}_D{width}_H{hid}",
                              "draws": draw + 1, **r.r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
