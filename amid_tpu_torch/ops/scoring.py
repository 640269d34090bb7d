"""Fused scoring head — the counterpart of `amid_tpu/ops/pallas_scoring.py`.

    scoring_head(user, items, w_user, w_item, b1, w2, b2)[b, c]
        = sigmoid( relu(user[b] W_u^T + items[b, c] W_i^T + b1) . w2 + b2 )

user: [B, D]; items: [B, C, D] (each user's own candidates); w_user, w_item:
[H, D], the two halves of the first layer's `[H, 2D]` weight (views into it
are fine: the kernel reads through their row stride, and autograd carries
both halves' gradients back into the one parameter); b1: [H]; w2: [1, H];
b2: [1]. All float32. Returns [B, C].

The forward is the kernel of `csrc/scoring_head.cu`, which never builds the
`[B, C, H]` hidden tensor. The backward is plain PyTorch that recomputes the
hidden layer (the TPU package has no backward kernel here either); it is the
transcription of `pallas_scoring.py::_bwd` to torch's `[out, in]` weights.

On CUDA tensors `scoring_head` launches the kernel (counting the launch in
`.launches`) or raises; on CPU tensors its forward is `scoring_head_plain`
and its backward the same recomputation, so the CPU tests reach it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from amid_tpu_torch.ops import _build
from amid_tpu_torch.ops._build import SMEM_LIMIT

_ROWS_PER_BLOCK = 32  # 8 warps x 4 candidates (csrc/scoring_head.cu)
_TARGET_BLOCKS = 1024  # about one wave of 256-thread blocks on 132 SMs


def scoring_head_plain(user, items, w_user, w_item, b1, w2, b2) -> torch.Tensor:
    """The same function in plain PyTorch, differentiable by autograd."""
    hidden = torch.relu(F.linear(user, w_user)[:, None, :] + F.linear(items, w_item) + b1)
    return torch.sigmoid(F.linear(hidden, w2, b2)[..., 0])


def _check(user, items, w_user, w_item, b1, w2, b2) -> None:
    if user.dim() != 2 or items.dim() != 3 or items.shape[0] != user.shape[0] \
            or items.shape[2] != user.shape[1]:
        raise ValueError(f"scoring_head: want user [B, D] and items [B, C, D]; got "
                         f"{tuple(user.shape)} and {tuple(items.shape)}")
    d, h = user.shape[1], b1.shape[0]
    want = {"w_user": (h, d), "w_item": (h, d), "b1": (h,), "w2": (1, h), "b2": (1,)}
    for (name, shape), x in zip(want.items(), (w_user, w_item, b1, w2, b2)):
        if tuple(x.shape) != shape:
            raise ValueError(f"scoring_head: {name} must be {shape}; got {tuple(x.shape)}")
    for name, x in (("user", user), ("items", items), ("w_user", w_user),
                    ("w_item", w_item), ("b1", b1), ("w2", w2), ("b2", b2)):
        if x.dtype != torch.float32:
            raise TypeError(f"scoring_head takes float32; {name} is {x.dtype}")
        if x.device != user.device:
            raise ValueError(f"scoring_head: {name} on {x.device}, user on {user.device}")


_fns = None  # the bound C entry points, resolved at the first launch


def _kernel_fns():
    """(scoring_head, scoring_head_smem_bytes) of `csrc/scoring_head.cu`, typed once."""
    global _fns
    if _fns is None:
        lib = _build.load("scoring_head")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        _fns = (
            _build.bind(lib.scoring_head, [
                p, ll, p, ll, ll, p, ll, p, ll,  # user, items, w_user, w_item + strides
                p, p, p, p,  # b1, w2, b2, out
                i, i, i, i, i, p,  # B, C, D, H, grid_y, stream
            ]),
            _build.bind(lib.scoring_head_smem_bytes, [i, i], ctypes.c_size_t),
        )
    return _fns


def grid_y(bsz: int, c: int) -> int:
    """Blocks that share one user's candidates: enough to fill the card at a
    small batch, never more than the candidates give work to."""
    return max(1, min(-(-c // _ROWS_PER_BLOCK), -(-_TARGET_BLOCKS // bsz), 65535))


def _launch(user, items, w_user, w_item, b1, w2, b2) -> torch.Tensor:
    bsz, c, d = items.shape
    h = b1.shape[0]
    if d % 4 != 0:
        raise ValueError(f"scoring_head: the kernel takes D a multiple of 4; got D={d}")
    kernel, smem_bytes = _fns or _kernel_fns()
    need = smem_bytes(d, h)
    if need > SMEM_LIMIT:
        raise ValueError(f"scoring_head: D={d}, H={h} needs {need} bytes of shared memory "
                         f"per block; the limit is {SMEM_LIMIT}")
    if items.stride(2) != 1 or items.stride(1) % 4 or items.stride(0) % 4 \
            or items.data_ptr() % 16:
        items = items.contiguous()  # the kernel loads item rows 16 bytes at a time
    user, w_user, w_item = (x if x.stride(-1) == 1 else x.contiguous()
                            for x in (user, w_user, w_item))
    b1, w2, b2 = b1.contiguous(), w2.contiguous(), b2.contiguous()
    out = torch.empty((bsz, c), dtype=torch.float32, device=user.device)
    err = kernel(
        user.data_ptr(), user.stride(0), items.data_ptr(), items.stride(0), items.stride(1),
        w_user.data_ptr(), w_user.stride(0), w_item.data_ptr(), w_item.stride(0),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        bsz, c, d, h, grid_y(bsz, c),
        _build.raw_stream(user.device.index),
    )
    if err != 0:
        raise RuntimeError(f"scoring_head kernel launch failed: cudaError {err}")
    scoring_head.launches += 1
    return out


class _ScoringHead(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward: the
    hidden layer recomputed in plain PyTorch; residuals are the inputs and
    the output."""

    @staticmethod
    def forward(ctx, user, items, w_user, w_item, b1, w2, b2):
        args = tuple(x.detach() for x in (user, items, w_user, w_item, b1, w2, b2))
        out = _launch(*args) if user.device.type == "cuda" else scoring_head_plain(*args)
        ctx.save_for_backward(user, items, w_user, w_item, b1, w2, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        user, items, w_user, w_item, b1, w2, out = ctx.saved_tensors
        pre = F.linear(user, w_user)[:, None, :] + F.linear(items, w_item) + b1  # [B, C, H]
        hidden = torch.relu(pre)
        dlogit = g * out * (1.0 - out)  # through the sigmoid, [B, C]
        dw2 = torch.einsum("bch,bc->h", hidden, dlogit)[None, :]
        db2 = dlogit.sum()[None]
        dpre = (dlogit[..., None] * w2[0]) * (pre > 0)  # [B, C, H]
        db1 = dpre.sum(dim=(0, 1))
        du_part = dpre.sum(dim=1)  # [B, H]
        duser = du_part @ w_user
        dw_user = du_part.T @ user
        ditems = dpre @ w_item
        dw_item = torch.einsum("bch,bcd->hd", dpre, items)
        return duser, ditems, dw_user, dw_item, db1, dw2, db2


def scoring_head(user, items, w_user, w_item, b1, w2, b2) -> torch.Tensor:
    """See the module docstring. Differentiable in all seven inputs. CUDA
    tensors launch the kernel (or raise); CPU tensors take
    `scoring_head_plain` in the forward."""
    if user.device.type not in ("cpu", "cuda"):
        raise ValueError(f"scoring_head runs on cuda or cpu, not {user.device}")
    _check(user, items, w_user, w_item, b1, w2, b2)
    return _ScoringHead.apply(user, items, w_user, w_item, b1, w2, b2)


scoring_head.launches = 0  # kernel launches since the last reset
