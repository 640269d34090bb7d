"""The gather's backward in the CUDA kernel's order (`embedding_gather_grad_ordered`:
a row's gradients summed from 0 in position order within each tile of
`GRAD_TILE` positions, then the tile sums from 0 in tile order) against a
scalar loop in that order, the plain version (`index_add_`) and the JAX
package's backward of the gather (`pallas_embedding._bwd`, XLA's
scatter-add).

The same numpy-seeded ids and gradients go through each. The scalar loop
adds the same fp32 terms in the same order, so it must agree bit for bit;
`index_add_` and XLA sum in orders of their own (atol 1e-4: the padding row
sums up to 700 terms near 1)."""

import struct

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from amid_tpu.ops.pallas_embedding import _bwd
from amid_tpu_torch.ops.embedding import (
    GRAD_TILE,
    embedding_gather_grad_ordered,
    embedding_gather_grad_plain,
)

V, D = 40, 8


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _scalar_order(ids, g, rows, tile):
    """The kernel's order, one fp32 add at a time."""
    out = np.zeros((rows, g.shape[1]), np.float32)
    keys = np.clip(ids, 0, rows - 1)
    for key in np.unique(keys):
        total = np.zeros(g.shape[1], np.float32)
        for t in range(-(-ids.size // tile)):
            at = [i for i in range(t * tile, min(ids.size, (t + 1) * tile)) if keys[i] == key]
            if not at:
                continue
            part = np.zeros(g.shape[1], np.float32)
            for i in at:
                part = part + g[i]
            total = total + part
        out[key] = total
    return out


def _padded_ids(rng, n, pad_share=0.6):
    """n ids with left padding's share of row 0, shuffled, and a few
    outside [0, V)."""
    ids = rng.integers(1, V, n).astype(np.int64)
    ids[rng.random(n) < pad_share] = 0
    ids[rng.integers(0, n, 3)] = [-4, V, V + 7]
    return ids


@pytest.mark.parametrize("n,tile", [(700, GRAD_TILE), (700, 32), (1000, 7), (129, GRAD_TILE)])
def test_ordered_backward_is_the_scalar_loop_bit_for_bit(rng, n, tile):
    """Runs that span many tiles (row 0 in every tile), out-of-range ids
    clamped, a last tile of one position: bit-equal to the scalar loop."""
    ids = _padded_ids(rng, n)
    g = rng.normal(size=(n, D)).astype(np.float32)
    got = embedding_gather_grad_ordered(torch.tensor(ids), torch.tensor(g), V, tile)
    np.testing.assert_array_equal(got.numpy(), _scalar_order(ids, g, V, tile))


@pytest.mark.parametrize("n", [0, 1, 2, 700, 3 * GRAD_TILE + 5])
def test_ordered_backward_equals_index_add_and_the_jax_backward(rng, n):
    """n = 0 and 1, a pair, and padded histories over several tiles, int32
    and int64 ids alike: within 1e-4 of `index_add_` and of the JAX
    backward (out-of-range ids clamped by both), and two calls bit-equal."""
    ids = _padded_ids(rng, n) if n >= 3 else rng.integers(0, V, n)
    g = rng.normal(size=(n, D)).astype(np.float32)
    for dtype in (torch.int32, torch.int64):
        t_ids, t_g = torch.tensor(ids, dtype=dtype), torch.tensor(g)
        got = embedding_gather_grad_ordered(t_ids, t_g, V)
        assert torch.equal(got, embedding_gather_grad_ordered(t_ids, t_g, V))
        assert got.shape == (V, D) and got.dtype == torch.float32
        torch.testing.assert_close(got, embedding_gather_grad_plain(t_ids, t_g, V),
                                   atol=1e-4, rtol=0)
    want, _ = _bwd(((V, D), jnp.asarray(np.clip(ids, 0, V - 1).astype(np.int32))),
                   jnp.asarray(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_ordered_backward_leaves_untouched_rows_zero(rng):
    """Rows no id reaches are +0.0, as the kernel writes them."""
    ids = np.array([3, 3, 9], np.int64)
    got = embedding_gather_grad_ordered(torch.tensor(ids), -torch.ones(3, D), V)
    assert got[3].eq(-2).all() and got[9].eq(-1).all()
    rest = torch.ones(V, dtype=torch.bool)
    rest[[3, 9]] = False
    assert got[rest].eq(0).all() and not torch.signbit(got[rest]).any()


def test_backward_launch_packs_each_lookup_as_a_segment(monkeypatch):
    """The CUDA launch's argument block (`csrc/gather_rows.cu`'s layout),
    read back on CPU tensors with the C entry points replaced by recorders:
    {segments, V, width, ids64, out, scratch, its bytes, device, stream},
    then each lookup's {ids, n, gradient, row stride} as they are (a
    strided gradient view keeps its stride; no concatenation); mixed id
    types go as int64; one launch is counted per call."""
    from amid_tpu_torch.ops import embedding

    seen = []

    def entry(raw):
        seen.append(raw)
        return 0

    monkeypatch.setattr(embedding, "_gather_rows_grad", entry)
    monkeypatch.setattr(embedding, "_grad_scratch", lambda n, v, w, dev: 48)
    monkeypatch.setattr(embedding, "_scratch_bytes", {})
    monkeypatch.setattr(embedding._build, "raw_stream", lambda index: 7)
    monkeypatch.setattr(embedding, "_PACK_GRAD", [None] + [
        (lambda f: lambda *a: f(*(0 if x is None else x for x in a)))(
            struct.Struct(f"{9 + 4 * k}q").pack) for k in range(1, 5)])
    a = torch.tensor([3, 1, 3], dtype=torch.int32)
    b = torch.tensor([[0, 9]], dtype=torch.int32)
    wide = torch.randn(2, 2 * D)
    ga, gb = torch.randn(3, D), wide[:, :D]  # a view: rows 2 D floats apart
    before = embedding.embedding_gather_grad.launches
    out = embedding._launch_grad([(a, ga), (b, gb)], V)
    assert embedding.embedding_gather_grad.launches == before + 1
    f = struct.unpack("17q", seen[-1])
    assert f[:5] == (2, V, D, 0, out.data_ptr()) and out.shape == (V, D)
    assert f[6:9] == (48, 0, 7) and f[5] % 16 == 0
    assert f[9:13] == (a.data_ptr(), 3, ga.data_ptr(), D)
    assert f[13:17] == (b.data_ptr(), 2, gb.data_ptr(), 2 * D)
    embedding._launch_grad([(a, ga), (b.long(), gb)], V)
    f = struct.unpack("17q", seen[-1])
    assert f[3] == 1 and f[9] != a.data_ptr()  # the int32 ids copied to int64
