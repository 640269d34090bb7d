"""Adam with optax's semantics — the counterpart of `optax.adam(lr)` as the
JAX trainer uses it (`amid_tpu/train/loop.py`).

    mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g^2
    p -= lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

with `eps` added outside the square root, `eps_root = 0` and the bias
correction by the step count t. Unlike `torch.optim.Adam`, which skips a
parameter whose gradient is `None`, EVERY leaf is updated at every step: a
leaf the loss did not reach takes a zero gradient, so its moments still decay
and it still moves by its decayed `mu`. The two DR phases alternate over the
same parameters with separate moments, which makes that difference visible.

The state is explicit (`AdamState`), as optax's is: `count` is an int32
tensor on the parameters' device that the step increments in place, `mu` and
`nu` are dictionaries of tensors keyed like the parameters. The bias
corrections 1 - b^t are computed on the device in float64 from the count and
then rounded to float32, so no host number enters a step and a CUDA graph of
the step replays with the count it finds. Updates are in place, over tensor
lists (`torch._foreach_*`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import torch


@dataclass
class AdamState:
    count: torch.Tensor  # int32 scalar on the parameters' device
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def new_count(device) -> torch.Tensor:
    """A step count of 0, as the device tensor a step increments."""
    return torch.zeros((), dtype=torch.int32, device=device)


def bias_correction(b: float, count: torch.Tensor) -> torch.Tensor:
    """1 - b^count, computed in float64 on the count's device, as float32."""
    return (1.0 - b ** count.to(torch.float64)).to(torch.float32)


class Adam:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> None:
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        device = next(iter(params.values())).device if params else "cpu"
        return AdamState(
            count=new_count(device),
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )

    @torch.no_grad()
    def update_(self, params: Mapping[str, torch.Tensor],
                grads: Mapping[str, Optional[torch.Tensor]],
                state: AdamState) -> None:
        """One step, in place on `params` and `state`. A missing or `None`
        gradient counts as zero."""
        if set(params) != set(state.mu):
            raise ValueError("parameters and optimizer state name different leaves: "
                             f"{sorted(set(params) ^ set(state.mu))}")
        names = list(params)
        ps = [params[k] for k in names]
        gs = [g if (g := grads.get(k)) is not None else torch.zeros_like(params[k])
              for k in names]
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        state.count.add_(1)
        bc2 = bias_correction(self.b2, state.count)
        # -lr / (1 - b1^t), in float64 and then float32, as the host's was
        step = (-self.lr / (1.0 - self.b1 ** state.count.to(torch.float64))).to(torch.float32)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, gs, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, gs, gs, value=1.0 - self.b2)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        # p += step * mu / denom as p += mu / (denom / step): one pass more
        # than an addcdiv with a host value, none over a new list
        torch._foreach_div_(denom, step)
        torch._foreach_addcdiv_(ps, mu, denom)
