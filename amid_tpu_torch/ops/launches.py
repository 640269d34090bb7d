"""The launch counts of every kernel wrapper, read, reset and advanced as one.

Each wrapper counts its launches in an attribute of its own (e.g.
`fused_attention.launches`). A count moves where the host launches a kernel,
so a CUDA graph counts its kernels once, while it is captured, and none at a
replay; the graph's owner (`train/graphs.py`) adds what the capture counted at
every replay, so that the counts stay launches on the device.
"""

from __future__ import annotations


def counters() -> dict:
    """kernel name -> (wrapper, attribute holding its count)."""
    from amid_tpu_torch.ops.affinity import max_affinity_blocked, max_affinity_smalln
    from amid_tpu_torch.ops.attention import fused_attention
    from amid_tpu_torch.ops.embedding import embedding_gather, embedding_gather_grad
    from amid_tpu_torch.ops.scatter import scatter_set_unique, scatter_set_unique3
    from amid_tpu_torch.ops.scoring import scoring_head

    return {"attention_fwd": (fused_attention, "launches"),
            "attention_fwd_long": (fused_attention, "long_forward_launches"),
            "attention_bwd": (fused_attention, "backward_launches"),
            "attention_bwd_long": (fused_attention, "long_backward_launches"),
            "scatter_set_unique3": (scatter_set_unique3, "launches"),
            "scatter_set_unique": (scatter_set_unique, "launches"),
            "embedding_gather": (embedding_gather, "launches"),
            "embedding_gather_grad": (embedding_gather_grad, "launches"),
            "scoring_head": (scoring_head, "launches"),
            "attention_fwd_bf16": (fused_attention, "bf16_launches"),
            "attention_fwd_long_bf16": (fused_attention, "long_forward_bf16_launches"),
            "attention_bwd_bf16": (fused_attention, "backward_bf16_launches"),
            "attention_bwd_long_bf16": (fused_attention, "long_backward_bf16_launches"),
            "scoring_head_bf16": (scoring_head, "bf16_launches"),
            "max_affinity_blocked": (max_affinity_blocked, "launches"),
            "max_affinity_smalln": (max_affinity_smalln, "launches")}


def read() -> dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}


def reset() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def since(before: dict[str, int]) -> dict[str, int]:
    """The launches counted since `before` (a `read()`), by kernel."""
    return {name: n - before[name] for name, n in read().items()}


def add(counts: dict[str, int]) -> None:
    """Adds `counts` (by kernel) to the wrappers' counts."""
    for name, (fn, attr) in counters().items():
        if counts.get(name):
            setattr(fn, attr, getattr(fn, attr) + counts[name])
