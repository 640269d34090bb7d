"""Fused scoring head — the counterpart of `amid_tpu/ops/pallas_scoring.py`.

    scoring_head(user, items, w_user, w_item, b1, w2, b2)[b, c]
        = sigmoid( relu(user[b] W_u^T + items[b, c] W_i^T + b1) . w2 + b2 )
    scoring_head_pair(user_d1, user_d2, items, w_user, w_item, b1, w2, b2)
        = (scoring_head(user_d1, items, ...), scoring_head(user_d2, items, ...))

user, user_d*: [B, D]; items: [B, C, D] (each user's own candidates); w_user,
w_item: [H, D], the two halves of the first layer's `[H, 2D]` weight (views
into it are fine: the kernel reads through their row stride, and autograd
carries both halves' gradients back into the one parameter); b1: [H]; w2:
[1, H]; b2: [1]. All float32. Returns [B, C] (the pair: two of them).

The forward is the kernel of `csrc/scoring_head.cu`, which never builds the
`[B, C, H]` hidden tensor; `scoring_head_pair` scores both user
representations in one launch and computes the item half `items W_i^T` once
for both (what `models/heads.py::PredictHead` calls: one launch per head).
Any D and H: `scoring_kernel` names the main kernel a shape takes (the
whole-tile kernel, the column-chunked one beside a whole Wi^T, or the wide
one, which also stages Wi^T in chunks of 256 rows and 32 units), and
`scoring_plan` its grid and shared memory.
The backward is plain PyTorch that recomputes the hidden layer (the TPU
package has no backward kernel here either); it is the transcription of
`pallas_scoring.py::_bwd` to torch's `[out, in]` weights, with the item half
recomputed once and both users' terms summed before the item-side products.

On CUDA tensors the wrappers launch the kernel (counting each launch in
`scoring_head.launches`, whichever wrapper made it) or raise; on CPU tensors
the forward is `scoring_head_plain` / `scoring_head_pair_plain` and the
backward the same recomputation, so the CPU tests reach it. The
`autograd.Function` is entered only when a gradient is wanted (grad mode on
and an input that requires one); otherwise the wrapper launches directly.

`bf16=True` is the model's bf16 mode (`ops.precision`), what the JAX head's
dots compute under the bfloat16 context: both products' operands rounded to
bf16 (user, W_u, items, W_i; the hidden unit and w2), sums in fp32. The
kernel rounds them as it loads them (the products are then exact on the
CUDA cores, as in fp32) and counts its launches in
`scoring_head.bf16_launches`; the plain versions and the backward round
through `ops.precision`'s products.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple

import torch

from amid_tpu_torch.ops import _build
from amid_tpu_torch.ops._build import SMEM_LIMIT
from amid_tpu_torch.ops.precision import bf16_round, einsum, linear, matmul

TILE_ROWS = 64  # candidates a block takes at a time (csrc/scoring_head.cu)
PASS_UNITS = 32  # hidden units a pass of the main kernels (kPass)
WIDE_COLS = 256  # columns of D a chunk of the wide kernel (kWideCols)
USER_ROWS, USER_UNITS = 128, 128  # the wide user half's chunk: columns of D, units
SM_COUNT = 132  # the H100 SXM's
_SM_SHARED = 233472  # shared memory of one SM, bytes; 1 KB of it is reserved per block


def _mode(bf16: bool) -> str:
    return "bf16" if bf16 else "fp32"


def scoring_head_plain(user, items, w_user, w_item, b1, w2, b2,
                       bf16: bool = False) -> torch.Tensor:
    """The same function in plain PyTorch, differentiable by autograd."""
    mode = _mode(bf16)
    hidden = torch.relu(linear(user, w_user, None, mode)[:, None, :]
                        + linear(items, w_item, None, mode) + b1)
    return torch.sigmoid(linear(hidden, w2, b2, mode)[..., 0])


def scoring_head_pair_plain(user_d1, user_d2, items, w_user, w_item, b1, w2, b2,
                            bf16: bool = False):
    """`scoring_head_pair` in plain PyTorch, differentiable by autograd: the
    item half is computed once and serves both users (what a
    kernels='torch' `PredictHead` computes)."""
    mode = _mode(bf16)
    i_part = linear(items, w_item, None, mode)  # [B, C, H]

    def score(u):
        hidden = torch.relu(linear(u, w_user, None, mode)[:, None, :] + i_part + b1)
        return torch.sigmoid(linear(hidden, w2, b2, mode)[..., 0])

    return score(user_d1), score(user_d2)


def _check(users, items, w_user, w_item, b1, w2, b2) -> None:
    """Every check that needs the tensors, for the kernel and the plain route
    alike: compares on the way in, the texts on the failure path only."""
    dev, f32 = items.get_device(), torch.float32
    if items.dim() == 3 and b1.dim() == 1:
        b, _, d = items.shape
        h = b1.shape[0]
        ud, hd = (b, d), (h, d)
        if (all(u.shape == ud and u.dtype is f32 and u.get_device() == dev for u in users)
                and w_user.shape == hd and w_item.shape == hd and w2.shape == (1, h)
                and b2.shape == (1,) and items.dtype is f32 and w_user.dtype is f32
                and w_item.dtype is f32 and b1.dtype is f32 and w2.dtype is f32
                and b2.dtype is f32 and w_user.get_device() == dev
                and w_item.get_device() == dev and b1.get_device() == dev
                and w2.get_device() == dev and b2.get_device() == dev
                and items.device.type in ("cpu", "cuda")):
            return
    _refuse(users, items, w_user, w_item, b1, w2, b2)


def _refuse(users, items, w_user, w_item, b1, w2, b2) -> None:
    """Raises with the text for what `_check` found wrong."""
    user = users[0]
    if items.dim() != 3 or any(u.dim() != 2 or u.shape[0] != items.shape[0]
                               or u.shape[1] != items.shape[2] for u in users):
        raise ValueError(f"scoring_head: want user [B, D] and items [B, C, D]; got "
                         f"{[tuple(u.shape) for u in users]} and {tuple(items.shape)}")
    d, h = user.shape[1], b1.shape[0]
    want = {"w_user": (h, d), "w_item": (h, d), "b1": (h,), "w2": (1, h), "b2": (1,)}
    for (name, shape), x in zip(want.items(), (w_user, w_item, b1, w2, b2)):
        if x.shape != shape:
            raise ValueError(f"scoring_head: {name} must be {shape}; got {tuple(x.shape)}")
    dev = user.device
    for name, x in (("user", user), *(("user_d2", u) for u in users[1:]), ("items", items),
                    ("w_user", w_user), ("w_item", w_item), ("b1", b1), ("w2", w2),
                    ("b2", b2)):
        if x.dtype is not torch.float32:
            raise TypeError(f"scoring_head takes float32; {name} is {x.dtype}")
        if x.device != dev:
            raise ValueError(f"scoring_head: {name} on {x.device}, user on {dev}")
    raise ValueError(f"scoring_head runs on cuda or cpu, not {dev}")


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------

class ScoringPlan(NamedTuple):
    """How the main kernel takes one shape: 64-row tiles of the B * C
    candidates, how many a block walks, the blocks, shared memory per block
    in bytes."""
    tiles: int
    tiles_per_block: int
    grid: int
    smem: int


def _smem_with(d: int, h: int, kw: int) -> int:
    d8, h8 = -(-d // 8) * 8, -(-h // 8) * 8
    tile, parts = TILE_ROWS * (kw + 4), 4 * TILE_ROWS * 33
    return 4 * (d8 * (h8 + 4) + h8 + (max(tile, parts) if h8 <= 32 else tile + parts))


_WIDE_SMEM = 4 * (TILE_ROWS * (WIDE_COLS + 4) + WIDE_COLS * (PASS_UNITS + 4) + PASS_UNITS)


def scoring_kernel(d: int, h: int) -> str:
    """The main kernel that takes (D, H) (csrc/scoring_head.cu,
    `main_kernel`): 'whole' (Wi^T and a whole candidate tile in shared
    memory: D up to 576 at H=32) or 'chunked' (Wi^T whole beside tiles
    staged in column chunks: D up to 1,376 at H=32, 704 at H=64), both at D
    a multiple of 4; 'wide' at every other shape (Wi^T staged in chunks
    too, and 4-byte copies at a D not a multiple of 4)."""
    if d % 4:
        return "wide"
    if _smem_with(d, h, -(-d // 8) * 8) <= SMEM_LIMIT:
        return "whole"
    return "chunked" if _smem_with(d, h, 16) <= SMEM_LIMIT else "wide"


def tile_cols(d: int, h: int) -> int:
    """The columns of a staged candidate tile (csrc/scoring_head.cu,
    `tile_cols`): the whole row, ceil8(D), on the whole-tile kernel; the
    widest multiple of 16 that fits beside Wi^T on the chunked one (320 at
    D=1024, H=32); WIDE_COLS on the wide one."""
    kernel = scoring_kernel(d, h)
    if kernel == "whole":
        return -(-d // 8) * 8
    if kernel == "wide":
        return WIDE_COLS
    return next(kw for kw in range((-(-d // 8) * 8 - 1) // 16 * 16, 15, -16)
                if _smem_with(d, h, kw) <= SMEM_LIMIT)


def scoring_smem_bytes(d: int, h: int) -> int:
    """Shared memory of one block of the main kernel. The whole-tile and
    chunked kernels: Wi transposed ([ceil8(D)][ceil8(H) + 4] floats), w2, a
    candidate tile of `tile_cols` columns at a row pitch of that + 4 floats
    and the four warps' parts of the item product ([4][64][33]), the parts
    in the tile's place when one pass of 32 units covers H. The wide kernel,
    at every D and H: a chunk of the tile (the parts in its place), the
    chunk's rows of Wi^T for a pass ([WIDE_COLS][PASS_UNITS + 4]) and the
    pass's w2, 103,552 bytes."""
    if scoring_kernel(d, h) == "wide":
        return _WIDE_SMEM
    return _smem_with(d, h, tile_cols(d, h))


def _user_half_whole(d: int, h: int) -> bool:
    return d % 4 == 0 and 4 * d * (-(-h // 8) * 8 + 1 + 4) <= SMEM_LIMIT


def user_half_smem_bytes(d: int, h: int) -> int:
    """Shared memory of one block of the user-half kernel: Wu transposed,
    [D][ceil8(H) + 1] floats, and a user row for each of its 4 warps, where
    that fits and D is a multiple of 4; else its wide form's chunk,
    [USER_ROWS][USER_UNITS + 1] floats and 4 rows of USER_ROWS."""
    if _user_half_whole(d, h):
        return 4 * d * (-(-h // 8) * 8 + 1 + 4)
    return 4 * USER_ROWS * (USER_UNITS + 1 + 4)


@functools.lru_cache(maxsize=512)
def scoring_plan(b: int, c: int, d: int, h: int) -> ScoringPlan:
    """Blocks of contiguous tile ranges: as many blocks as fit on the card at
    once (SM_COUNT SMs, each as many as its shared memory holds), the tiles
    spread evenly over them. Every (D, H) has one (`scoring_kernel`)."""
    smem = scoring_smem_bytes(d, h)
    tiles = -(-b * c // TILE_ROWS)
    per_sm = max(1, _SM_SHARED // (smem + 1024))
    tpb = -(-tiles // min(tiles, SM_COUNT * per_sm)) if tiles else 1
    return ScoringPlan(tiles, tpb, -(-tiles // tpb), smem)


# the entry point's ScoreArgs block (csrc/scoring_head.cu): 24 8-byte fields
_PACK = struct.Struct("<24q").pack
_kernel = None  # the bound entry point, resolved at the first launch


def _bind() -> None:
    global _kernel
    _kernel = _build.bind(_build.load("scoring_head").scoring_head, [ctypes.c_char_p])


def smem_bytes_of_the_kernels():
    """(scoring_head_smem_bytes, scoring_user_half_smem_bytes) of the C
    library, typed: the kernels' own shared-memory arithmetic, for the tests."""
    lib, i = _build.load("scoring_head"), ctypes.c_int
    return (_build.bind(lib.scoring_head_smem_bytes, [i, i], ctypes.c_size_t),
            _build.bind(lib.scoring_user_half_smem_bytes, [i, i], ctypes.c_size_t))


def _unit(x: torch.Tensor):
    """(x, its strides), x copied if its last axis is not of unit stride."""
    st = x.stride()
    if st[-1] != 1:
        x = x.contiguous()
        st = x.stride()
    return x, st


def _launch(users, items, w_user, w_item, b1, w2, b2, bf16=False):
    """One launch for one or two users on checked CUDA tensors: a tuple of
    [B, C] scores, one a user; `bf16`: the bf16-operand mode."""
    if _kernel is None:
        _bind()
    bsz, c, d = items.shape
    h = b1.shape[0]
    n = len(users)
    plan = scoring_plan(bsz, c, d, h)
    # copies stay referenced until the launch is in the stream; the item rows
    # are copied 16 bytes at a time (4 at a D not a multiple of 4), the rest
    # is read by element
    ist, iptr = items.stride(), items.data_ptr()
    if ist[2] != 1 or (d % 4 == 0 and ((ist[0] | ist[1]) & 3 or iptr & 15)):
        items = items.contiguous()
        ist, iptr = items.stride(), items.data_ptr()
    user0, st0 = _unit(users[0])
    user1, st1 = _unit(users[1]) if n == 2 else (user0, st0)
    (w_user, wu_st), (w_item, wi_st) = _unit(w_user), _unit(w_item)
    b1, w2 = b1.contiguous(), w2.contiguous()
    # the scores, then the user half of the first layer ([n, B, ceil8(H)]
    # floats of scratch), in one allocation
    rows = bsz * c
    up_at = -(-n * rows // 4) * 4  # the scratch starts 16-byte aligned
    out = items.new_empty(up_at + n * bsz * -(-h // 8) * 8)
    optr = out.data_ptr()
    err = _kernel(_PACK(
        user0.data_ptr(), user1.data_ptr(), st0[0], st1[0], iptr, ist[0], ist[1],
        w_user.data_ptr(), wu_st[0], w_item.data_ptr(), wi_st[0], b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), optr, n, bsz, c, d, h, plan.tiles_per_block,
        optr + 4 * up_at, _build.raw_stream(items.device.index), int(bf16)))
    if err:
        if err == -1:
            raise ValueError(f"scoring_head: arguments the kernel does not take "
                             f"(items {tuple(items.shape)}, H={h})")
        raise RuntimeError(f"scoring_head kernel launch failed: cudaError {err}")
    if bf16:
        scoring_head.bf16_launches += 1
    else:
        scoring_head.launches += 1
    if n == 2:
        return out.as_strided((bsz, c), (c, 1)), out.as_strided((bsz, c), (c, 1), rows)
    return (out.as_strided((bsz, c), (c, 1)),)


def _forward(users, items, w_user, w_item, b1, w2, b2, bf16) -> tuple:
    """The forward of both wrappers on checked tensors, without autograd."""
    if items.is_cuda:
        return _launch(users, items, w_user, w_item, b1, w2, b2, bf16)
    with torch.no_grad():
        if len(users) == 2:
            return scoring_head_pair_plain(*users, items, w_user, w_item, b1, w2, b2,
                                           bf16=bf16)
        return (scoring_head_plain(users[0], items, w_user, w_item, b1, w2, b2, bf16=bf16),)


class _Scoring(torch.autograd.Function):
    """Forward: one kernel launch (CUDA) or the plain version (CPU) for one or
    two users. Backward: the hidden layer recomputed in plain PyTorch, the
    item half once; residuals are the inputs and the outputs. In bf16 mode
    every product of the backward rounds its operands, as the transposed
    dots of the JAX head do under the bfloat16 context."""

    @staticmethod
    def forward(ctx, bf16, items, w_user, w_item, b1, w2, b2, *users):
        outs = _forward(users, items, w_user, w_item, b1, w2, b2, bf16)
        ctx.save_for_backward(items, w_user, w_item, b1, w2, *users, *outs)
        ctx.n_users, ctx.bf16 = len(users), bf16
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        items, w_user, w_item, b1, w2, *rest = ctx.saved_tensors
        users, outs = rest[:ctx.n_users], rest[ctx.n_users:]
        mode = _mode(ctx.bf16)
        rnd = bf16_round if ctx.bf16 else (lambda x: x)
        i_part = linear(items, w_item, None, mode) + b1  # [B, C, H], once for both users
        dw2 = db2 = db1 = dw_user = dpre_sum = None
        dusers = []
        for user, out, g in zip(users, outs, grads):
            pre = linear(user, w_user, None, mode)[:, None, :] + i_part
            dlogit = g * out * (1.0 - out)  # through the sigmoid, [B, C]
            dpre = (rnd(dlogit)[..., None] * rnd(w2[0])) * (pre > 0)  # [B, C, H]
            du_part = dpre.sum(dim=1)  # [B, H]
            terms = (einsum("bch,bc->h", torch.relu(pre), dlogit, mode=mode)[None, :],
                     dlogit.sum()[None], dpre.sum(dim=(0, 1)),
                     matmul(du_part.T, user, mode), dpre)
            if dw2 is None:
                dw2, db2, db1, dw_user, dpre_sum = terms
            else:
                dw2, db2, db1, dw_user, dpre_sum = (a + t for a, t in zip(
                    (dw2, db2, db1, dw_user, dpre_sum), terms))
            dusers.append(matmul(du_part, w_user, mode))
        ditems = matmul(dpre_sum, w_item, mode)
        dw_item = einsum("bch,bcd->hd", dpre_sum, items, mode=mode)
        return (None, ditems, dw_user, dw_item, db1, dw2, db2, *dusers)


def _score(users, items, w_user, w_item, b1, w2, b2, bf16) -> tuple:
    _check(users, items, w_user, w_item, b1, w2, b2)
    if torch.is_grad_enabled() and (
            w_user.requires_grad or w_item.requires_grad or items.requires_grad
            or b1.requires_grad or w2.requires_grad or b2.requires_grad
            or any(u.requires_grad for u in users)):
        return _Scoring.apply(bf16, items, w_user, w_item, b1, w2, b2, *users)
    return _forward(users, items, w_user, w_item, b1, w2, b2, bf16)


def scoring_head(user, items, w_user, w_item, b1, w2, b2, bf16: bool = False) -> torch.Tensor:
    """See the module docstring. Differentiable in all seven inputs. CUDA
    tensors launch the kernel (or raise); CPU tensors take
    `scoring_head_plain` in the forward."""
    return _score((user,), items, w_user, w_item, b1, w2, b2, bf16)[0]


def scoring_head_pair(user_d1, user_d2, items, w_user, w_item, b1, w2, b2,
                      bf16: bool = False):
    """Both user representations against the same candidates in one launch:
    (scoring_head(user_d1, items, ...), scoring_head(user_d2, items, ...)),
    differentiable in all eight inputs. CUDA tensors launch the kernel (or
    raise); CPU tensors take `scoring_head_pair_plain` in the forward."""
    return _score((user_d1, user_d2), items, w_user, w_item, b1, w2, b2, bf16)


scoring_head.launches = 0  # fp32 kernel launches since the last reset, of both wrappers
scoring_head.bf16_launches = 0  # bf16-operand kernel launches
