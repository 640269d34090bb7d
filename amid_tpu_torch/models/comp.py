"""AMID peer message passing — the counterpart of `amid_tpu/models/comp.py`.

InnerComp (model_seq.py:450-472) exchanges messages between users within a
domain; InterComp (model_seq.py:474-497) takes affinity and messages from the
peers' other-domain sequences. Both append the aggregated message along time.

`broadcast_quirk=True` (the default, what the reference computes): the
affinity is each user's own diagonal a[j] = max seq_self[j] . seq_peer[j]^T,
the gate g = 1[softmax_j(a) > threshold] is one vector for the batch, and the
message is ONE [M, D] tensor shared by every user:

    msg = sum_j (w_bs[j] g[j]) P_j + (sum_j w_bs[j]) b_nn + b_bs,  P_j = seq_peer[j] Wn^T

`broadcast_quirk=False` (the idealized pairwise reading): A[b, c] is the
all-pairs max affinity, the gate is per (b, c) and the message per user. The
affinity comes from `ops.affinity.max_affinity` by the model's `kernels`:
`'cuda'` launches the hand-written kernels (bf16 inputs), `'torch'` computes
it in fp32. `PeerMessage.affinity` holds that function and may be replaced,
e.g. by `max_affinity_plain` to build a reference for the kernels' gates.

`precision` is the model's mode (`ops.precision`): in `"bf16"` the quirk
gate's affinity, the pairwise affinity of `kernels='torch'`
(`max_affinity_plain`), trans_nn's product and the message sums take bf16
operands, as the JAX package's einsums do under the bfloat16 context.

In both modes trans_nn's bias leaks through masked-out peers (the reference
applies trans_nn after masking, so trans_nn(0) = b_nn still reaches trans_bs),
and the hard gate passes no gradient to the affinity (getBinaryTensor,
model_seq.py:445-448). `trans_bs` is Linear(batch_size, 1), so the batch must
be exactly `batch_size` (model_seq.py:457).

On a mesh (inside `parallel.context.spmd`) a rank holds its rows of the
global batch, and the contraction is over the global batch, as in the JAX
package's shard_map hook: in quirk mode the diagonal affinity [b_local] is
computed locally and all-gathered over `data` with the peer bank, in the
same data-rank order (the order `trans_bs`'s weight indexes); in pairwise
mode the peer bank alone is gathered and the gate's rows stay local. The
gather's backward hands each rank's rows the gradient of every rank's loss
(`parallel.collectives.all_gather_data`).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch import nn

from amid_tpu_torch.ops.affinity import diag_max_affinity, max_affinity
from amid_tpu_torch.ops.precision import einsum, matmul
from amid_tpu_torch.parallel import context
from amid_tpu_torch.parallel.collectives import all_gather_data
from amid_tpu_torch.ops.torch_compat import torch_linear_init_


class PeerMessage(nn.Module):
    """Affinity-gated peer aggregation; returns the message [B, M, D]."""

    def __init__(self, d: int, batch_size: int, threshold: float,
                 broadcast_quirk: bool = True, kernels: str = "torch",
                 affinity: Optional[Callable] = None, precision: str = "fp32"):
        super().__init__()
        self.batch_size = batch_size
        self.threshold = threshold
        self.broadcast_quirk = broadcast_quirk
        self.precision = precision
        # pairwise mode's A[b, c]: (seq_self, seq_peer) -> [B, C]
        self.affinity = affinity or functools.partial(
            max_affinity, kernels=kernels, bf16=precision == "bf16")
        self.trans_nn = nn.Linear(d, d)
        self.trans_bs = nn.Linear(batch_size, 1)

    def reset_parameters(self, gen: torch.Generator) -> None:
        torch_linear_init_(self.trans_nn, gen)
        torch_linear_init_(self.trans_bs, gen)

    def gate_probabilities(self, seq_self: torch.Tensor,
                           seq_peer: torch.Tensor) -> torch.Tensor:
        """The softmax of the affinity that the threshold is held against:
        [B] over the batch in quirk mode, [B, B] over each row's peers in
        pairwise mode."""
        with torch.no_grad():
            if self.broadcast_quirk:
                return torch.softmax(diag_max_affinity(
                    seq_self, seq_peer, self.precision == "bf16"), dim=0)
            return torch.softmax(self.affinity(seq_self, seq_peer), dim=1)

    def gate(self, seq_self: torch.Tensor, seq_peer: torch.Tensor) -> torch.Tensor:
        """The hard 0/1 gate: [B] in quirk mode, [B, B] in pairwise mode."""
        probs = self.gate_probabilities(seq_self, seq_peer)
        return (probs > self.threshold).to(seq_self.dtype)

    def _mesh_gate(self, axes, seq_self: torch.Tensor, seq_peer: torch.Tensor):
        """(the hard gate, the global peer bank) of this rank's rows."""
        if self.broadcast_quirk:
            with torch.no_grad():
                aff = all_gather_data(diag_max_affinity(
                    seq_self, seq_peer, self.precision == "bf16"), axes)  # [B]
            seq_peer = all_gather_data(seq_peer, axes)
            return (torch.softmax(aff, dim=0) > self.threshold).to(seq_self.dtype), seq_peer
        seq_peer = all_gather_data(seq_peer, axes)
        return self.gate(seq_self, seq_peer), seq_peer

    def forward(self, seq_self: torch.Tensor, seq_peer: torch.Tensor) -> torch.Tensor:
        axes = context.current()
        if axes is not None:
            adj, seq_peer = self._mesh_gate(axes, seq_self, seq_peer)
        if seq_peer.shape[0] != self.batch_size:
            raise ValueError(
                f"the peer batch must be exactly batch_size={self.batch_size} "
                f"(trans_bs is Linear(batch_size, 1)); got {seq_peer.shape[0]}"
            )
        if axes is None:
            adj = self.gate(seq_self, seq_peer)
        w_bs, mode = self.trans_bs.weight[0], self.precision  # [C]
        peer_proj = matmul(seq_peer, self.trans_nn.weight.T, mode)  # [C, M, D]
        leak = w_bs.sum() * self.trans_nn.bias + self.trans_bs.bias
        if self.broadcast_quirk:
            msg = einsum("c,cme->me", adj * w_bs, peer_proj, mode=mode) + leak
            return msg.expand((seq_self.shape[0],) + msg.shape)
        msg = einsum("bc,cme->bme", adj * w_bs[None, :], peer_proj, mode=mode)
        return msg + leak


class InnerComp(nn.Module):
    """Intra-domain message passing; doubles the time axis (model_seq.py:471)."""

    def __init__(self, d: int, batch_size: int, threshold: float,
                 broadcast_quirk: bool = True, kernels: str = "torch",
                 precision: str = "fp32"):
        super().__init__()
        self.message = PeerMessage(d, batch_size, threshold, broadcast_quirk, kernels,
                                   precision=precision)

    def forward(self, seq: torch.Tensor) -> torch.Tensor:
        return torch.cat([seq, self.message(seq, seq)], dim=1)


class InterComp(nn.Module):
    """Cross-domain message passing, seq_peer -> seq_self (model_seq.py:483-497);
    the model applies it once in each direction."""

    def __init__(self, d: int, batch_size: int, threshold: float,
                 broadcast_quirk: bool = True, kernels: str = "torch",
                 precision: str = "fp32"):
        super().__init__()
        self.message = PeerMessage(d, batch_size, threshold, broadcast_quirk, kernels,
                                   precision=precision)

    def forward(self, seq_self: torch.Tensor, seq_peer: torch.Tensor) -> torch.Tensor:
        return torch.cat([seq_self, self.message(seq_self, seq_peer)], dim=1)
