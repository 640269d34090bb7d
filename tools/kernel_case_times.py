#!/usr/bin/env python3
"""Device times of kernel instances, for comparing two trees on one card.

The instances a change must leave as they were: K5's pair at B=256, C=1000
on the whole-tile kernel (D=128, H=32) and on the column-chunked one
(D=1,024, H=32), and K1's fp32 long backward at head width 256 (B=256, 4
heads of 256, T=300, key padding with batch row 0 fully masked, rate 0.1).
And the long forwards, both modes (`FWD_CASES`: B=256, 4 heads, key padding
as above or causal): the bf16 kernel at dh=128 and 256 (T=300: the
configurations' shapes; rates 0.1 and 0) and at dh=32 (T=600 and 1,200:
C2DSR BERT4Rec's views), the fp32 kernel at dh=256 (key padding and causal,
rates 0 and 0.1) and at dh=128 and 32. Each forward case prints `digest`,
a SHA-256 of its output and row statistics' bytes, so that two trees'
outputs compare bit for bit; with `--library` also SDPA's device time on the same inputs
(bf16 q, k, v for the bf16 cases) and the case's bound
(`chip_smoke.attention_bound`: the bf16 or TF32 tensor-core peak); with
`--parts` each kernel's device microseconds a call from a `torch.profiler`
trace (`chip_smoke.kernel_parts_us`: the pre-pass and the kernel apart).

Each case prints one JSON line with the tree's tag, the card and
`device_ms` (a CUDA graph of chip_smoke.py's GRAPH_CALLS calls, replayed,
`chip_smoke.graph_ms`). Every case's inputs come from a generator seeded by
the case's number, so every tree sees the same inputs.

    python3 tools/kernel_case_times.py --root <tree> --tag <name> \
        [--library] [--parts] [--only fwd|kept]

`--root` is the checkout whose `amid_tpu_torch` and `chip_smoke.py` are
timed (this one by default), so that one call can time a parent tree and a
change in turns. Needs one CUDA card and nvcc; imports nothing of JAX."""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

# (mode, heads, dh, T, bias, rate) of the long forward's cases, B=256
FWD_CASES = (
    ("bf16", 4, 128, 300, "keypad", 0.1),
    ("bf16", 4, 128, 300, "keypad", 0.0),
    ("bf16", 4, 256, 300, "keypad", 0.1),
    ("bf16", 4, 256, 300, "keypad", 0.0),
    ("bf16", 4, 256, 300, "causal", 0.1),
    ("bf16", 4, 32, 600, "keypad", 0.1),
    ("bf16", 4, 32, 1200, "keypad", 0.1),
    ("fp32", 4, 256, 300, "keypad", 0.0),
    ("fp32", 4, 256, 300, "keypad", 0.1),
    ("fp32", 4, 256, 300, "causal", 0.0),
    ("fp32", 4, 256, 300, "causal", 0.1),
    ("fp32", 4, 128, 300, "keypad", 0.1),
    ("fp32", 4, 32, 1200, "keypad", 0.1),
)


def digest(tensors) -> str:
    """SHA-256 (first 16 hex digits) of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--tag", default="tree")
    parser.add_argument("--library", action="store_true",
                        help="also time SDPA on each forward case's inputs and give its bound")
    parser.add_argument("--only", choices=("fwd", "kept"),
                        help="the forward cases alone, or the kept instances alone")
    parser.add_argument("--parts", action="store_true",
                        help="also each forward case's kernels' device us a call (a trace)")
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

    def emit(case, ms, **more):
        print(json.dumps({"tag": args.tag, "gpu": gpu, "case": case, "device_ms": ms, **more}),
              flush=True)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    b = 256
    if args.only != "fwd":
        gen.manual_seed(5)
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
            res = attention_fwd_stats_plain(q, k, v, bias, seed, heads, rate)
            emit("fp32_bwd_long_keypad_T300_dh256_rate0.1", cs.graph_ms(
                torch, lambda: attention_ops._launch_backward(q, k, v, bias, *res, dout, seed,
                                                              heads, rate, "long")))
        del q, k, v, dout, res
    if args.only == "kept":
        return 0
    for number, (mode, heads, dh, t, kind, rate) in enumerate(FWD_CASES):
        gen.manual_seed(100 + number)
        d = heads * dh
        q, k, v = (rand(b, t, d) for _ in range(3))
        bias = (torch.triu(torch.full((t, t), -1e9, device="cuda"), diagonal=1)[None, None]
                if kind == "causal" else cs.keypad_bias(torch, gen, b, t))
        seed = torch.tensor([4242], dtype=torch.int64, device="cuda")
        bf16 = mode == "bf16"

        def fwd(stats=False):
            return attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, stats,
                                                 "long", bf16=bf16)

        with torch.no_grad():
            outs = fwd(True)
            torch.cuda.synchronize()
            more = {"digest": digest(outs), "repeatable": digest(fwd(True)) == digest(outs),
                    "finite": bool(torch.isfinite(outs[0]).all().item())}
            del outs
            ms = cs.graph_ms(torch, lambda: fwd()[0])
            if args.parts:  # the pre-pass and the kernel apart
                more["parts_us"] = cs.kernel_parts_us(torch, lambda: fwd()[0])
            if args.library:
                rec = {}
                cs.sdpa_timings(torch, rec, q, k, v, None, bias, heads, rate, bf16)
                more["library_device_ms"] = rec["library_device_ms"]
                more["bound_ms"], more["bound_by"] = cs.attention_bound(
                    b, t, d, heads, bias.numel(),
                    cs.BF16_TENSOR_FLOPS if bf16 else cs.TF32_TENSOR_FLOPS)
        emit(f"{mode}_fwd_long_{kind}_T{t}_dh{dh}_rate{rate}", ms, **more)
        del q, k, v, bias
    return 0


if __name__ == "__main__":
    sys.exit(main())
