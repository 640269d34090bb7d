#!/usr/bin/env python3
"""Device times of the kernel instances that a change must leave as they
were, for comparing two trees on one card: K5's pair at B=256, C=1000 on
the whole-tile kernel (D=128, H=32) and on the column-chunked one (D=1,024,
H=32), and K1's fp32 long pair at head width 256 (B=256, 4 heads of 256,
T=300, key padding with batch row 0 fully masked, rate 0.1). Each prints one
JSON line with the tree's tag, the card and `device_ms` (a CUDA graph of
chip_smoke.py's GRAPH_CALLS calls, replayed, `chip_smoke.graph_ms`).

    python3 tools/kernel_case_times.py --root <tree> --tag <name>

`--root` is the checkout whose `amid_tpu_torch` and `chip_smoke.py` are
timed (this one by default), so that one call can time a parent tree and a
change in turns. Needs one CUDA card and nvcc; imports nothing of JAX."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--tag", default="tree")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import chip_smoke as cs
    from amid_tpu_torch.ops import attention as attention_ops
    from amid_tpu_torch.ops.attention import attention_fwd_stats_plain
    from amid_tpu_torch.ops.scoring import scoring_head_pair

    if not torch.cuda.is_available():
        print("kernel_case_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def emit(case, ms):
        print(json.dumps({"tag": args.tag, "gpu": gpu, "case": case, "device_ms": ms}),
              flush=True)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    b = 256
    for d, h in ((128, 32), (1024, 32)):
        fc1 = rand(h, 2 * d, scale=(2 * d) ** -0.5)
        params = (fc1[:, :d], fc1[:, d:], rand(h, scale=0.1), rand(1, h, scale=h ** -0.5),
                  rand(1, scale=0.1))
        user, other, items = rand(b, d), rand(b, d), rand(b, 1000, d)
        with torch.no_grad():
            emit(f"scoring_pair_C1000_D{d}_H{h}",
                 cs.graph_ms(torch, lambda: scoring_head_pair(user, other, items, *params)))
        del user, other, items
    heads, dh, t, rate = 4, 256, 300, 0.1
    q, k, v, dout = (rand(b, t, heads * dh) for _ in range(4))
    bias = cs.keypad_bias(torch, gen, b, t)
    seed = torch.tensor([4242], dtype=torch.int64, device="cuda")
    with torch.no_grad():
        emit("fp32_fwd_long_keypad_T300_dh256_rate0.1", cs.graph_ms(
            torch, lambda: attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, False,
                                                         "long")[0]))
        res = attention_fwd_stats_plain(q, k, v, bias, seed, heads, rate)
        emit("fp32_bwd_long_keypad_T300_dh256_rate0.1", cs.graph_ms(
            torch, lambda: attention_ops._launch_backward(q, k, v, bias, *res, dout, seed, heads,
                                                          rate, "long")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
