#!/usr/bin/env python3
"""The crossover sweeps behind the port's route tables, on one CUDA card:
both forward and both backward attention paths' device time where both take
a shape, fp32 and bf16 (the tables `LONG_FWD_FASTER_FROM` and
`LONG_FASTER_FROM` of `amid_tpu_torch/ops/attention.py`), at dh=128 too,
and both affinity kernels' at N=M from 8 to 80 (`smalln_faster` of
`amid_tpu_torch/ops/affinity.py`). Each sweep also holds the two paths'
outputs to each other. The functions are `chip_smoke.py`'s
(`fwd_crossover_sweep`, `bf16_crossover_sweeps`, `width_crossover_sweeps`,
`affinity_crossover_sweep`); the fp32 backward's sweep stays in
`chip_smoke.py`'s phase 2, where it also holds both backward paths to fp64.
One JSON record a shape on standard output.

    python3 tools/route_sweeps.py [fwd bf16 width affinity]

Needs nvcc; imports nothing of JAX."""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SWEEPS = {"fwd": "fwd_crossover_sweep", "bf16": "bf16_crossover_sweeps",
          "width": "width_crossover_sweeps", "affinity": "affinity_crossover_sweep"}


def main(argv: list[str]) -> int:
    import torch

    import chip_smoke as cs
    from amid_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("route_sweeps: no CUDA device", file=sys.stderr)
        return 2
    names = argv or list(SWEEPS)
    unknown = [n for n in names if n not in SWEEPS]
    if unknown:
        print(f"route_sweeps: unknown sweep {unknown}; choose from {list(SWEEPS)}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(sorted({Path(src).stem for src, _ in cs.KERNELS.values()} |
                        set(_build.VARIANTS)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for name in names:
        t0 = time.perf_counter()
        getattr(cs, SWEEPS[name])(torch, gen)
        torch.cuda.empty_cache()
        print(f"{SWEEPS[name]}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
