#!/usr/bin/env python3
"""The step timings behind PERF.md's table of eager and replayed steps:
`chip_smoke.py`'s phases 4 (the run.sh model, quirk and pairwise), 7
(BERT4Rec and GRU4Rec) and 8 (C2DSR) with `chip_smoke.STEP_TIMING` on, so
that each configuration's phase-A and phase-B steps and evaluation batch are
timed and traced eager and replayed (`step_timing` records: wall ms, device
ms from a `torch.profiler` trace, the device's idle share, the top
kernels). The phases' checks run as in `chip_smoke.py`; the traces take
about four minutes of the run (NVIDIA H100 80GB HBM3, 700.00 W). Phase
13(b), `wide_config`, adds configuration (d)'s replayed phase A (wall and
device ms, peak memory: its `wide_config` record) to the steps it replays.

    python3 tools/step_timings.py [training backbone c2dsr wide_config]

Needs one CUDA card and nvcc; imports nothing of JAX."""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# phase -> (chip_smoke's function, the numpy seed main() gives it)
PHASES = {"training": ("training_phase", 1), "backbone": ("backbone_phase", 3),
          "c2dsr": ("c2dsr_phase", 4), "wide_config": ("wide_config_phase", 10)}


def main(argv: list[str]) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from amid_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("step_timings: no CUDA device", file=sys.stderr)
        return 2
    names = argv or list(PHASES)
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        print(f"step_timings: unknown phase {unknown}; choose from {list(PHASES)}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(sorted({Path(src).stem for src, _ in cs.KERNELS.values()} |
                        set(_build.VARIANTS)))
    cs.STEP_TIMING = True
    for name in names:
        fn, seed = PHASES[name]
        t0 = time.perf_counter()
        getattr(cs, fn)(torch, np.random.default_rng(seed))
        torch.cuda.empty_cache()
        print(f"{fn}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
