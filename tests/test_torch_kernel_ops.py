"""The plain versions and the autograd Functions of the port's gather,
scoring-head and max-affinity ops against the JAX package's Pallas kernels,
run on the CPU in interpret mode as the JAX package's own tests run them.
The same numpy-seeded fp32 inputs go through both; on CPU tensors the port's
wrappers take their plain versions and launch nothing."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from amid_tpu.ops.affinity import max_affinity_xla as jax_max_affinity_xla
from amid_tpu.ops.pallas_affinity import max_affinity_pallas, max_affinity_pallas_smalln
from amid_tpu.ops.pallas_embedding import embedding_gather_pallas
from amid_tpu.ops.pallas_scoring import scoring_head_pallas
from amid_tpu_torch.ops import affinity, embedding, scoring


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# max-affinity
# ---------------------------------------------------------------------------

AFFINITY_SHAPES = [  # (B, N), (C, M), D
    ((16, 8), (16, 8), 128),  # square, tests/test_pallas.py's shape
    ((11, 4), (13, 4), 128),  # ragged batches: padding rows must not leak
    ((9, 7), (5, 3), 32),  # N != M
]


@pytest.mark.parametrize("jax_kernel", ["blocked", "smalln"])
@pytest.mark.parametrize("a_shape,b_shape,d", AFFINITY_SHAPES)
def test_max_affinity_plain_matches_the_pallas_kernels(rng, jax_kernel, a_shape, b_shape, d):
    """Same bf16 rounding of the inputs, exact products, fp32 sums in another
    order: rtol 1e-5 / atol 1e-5."""
    a, b = _normal(rng, *a_shape, d), _normal(rng, *b_shape, d)
    fn = max_affinity_pallas if jax_kernel == "blocked" else max_affinity_pallas_smalln
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(jnp.asarray(a), jnp.asarray(b)))
    got = affinity.max_affinity_plain(torch.as_tensor(a), torch.as_tensor(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (a_shape[0], b_shape[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # against the fp32 contraction only at the JAX tests' bf16 tolerance
    fp32 = np.asarray(jax_max_affinity_xla(jnp.asarray(a), jnp.asarray(b), chunk=1))
    np.testing.assert_allclose(got.numpy(), fp32, rtol=2e-2, atol=2e-1)
    assert not np.array_equal(got.numpy(), fp32)  # the rounding is really there


def test_max_affinity_wrappers_and_dispatch_on_the_cpu(rng):
    """On CPU tensors both kernel wrappers are the plain version and count no
    launch; the dispatcher sends 'cuda' to them and anything else to fp32."""
    a, b = torch.as_tensor(_normal(rng, 6, 5, 32)), torch.as_tensor(_normal(rng, 4, 5, 32))
    before = (affinity.max_affinity_blocked.launches, affinity.max_affinity_smalln.launches)
    plain = affinity.max_affinity_plain(a, b)
    for fn in (affinity.max_affinity_blocked, affinity.max_affinity_smalln):
        assert torch.equal(fn(a, b), plain)
    assert torch.equal(affinity.max_affinity(a, b, "cuda"), plain)
    fp32 = affinity.max_affinity_xla(a, b)
    assert torch.equal(affinity.max_affinity(a, b, "torch"), fp32)
    assert torch.equal(affinity.max_affinity(a, b), fp32)
    assert not torch.equal(plain, fp32)
    assert before == (affinity.max_affinity_blocked.launches,
                      affinity.max_affinity_smalln.launches)
    with pytest.raises(ValueError, match=r"\[B, N, D\]"):
        affinity.max_affinity_blocked(a, b[..., :16])
    with pytest.raises(TypeError, match="float32"):
        affinity.max_affinity_smalln(a.double(), b.double())


def test_smalln_plan_at_its_edges():
    """The small-N kernel packs U = 8, 4 or 2 users into a slot of at most
    160 query columns, W = ceil8(N * U): 8 users of 20 rows fill a slot
    exactly, two users of 80 are the last that fit, N = 81 is refused naming
    the limit; the plan does not depend on D within one 128-column plane
    (any D from 1 to 128). The dispatch sends every N the small-N kernel
    takes to it."""
    assert affinity.SMALLN_MAX_N == 80
    for d in (*range(8, 129, 8), 1, 20, 100):
        plan = affinity.smalln_plan(256, 256, 20, 20, d)  # the mybank shape
        assert (plan.width, plan.users, plan.chunks, plan.groups, plan.slices, plan.peers,
                plan.stages) == (160, 8, 1, 8, 16, 16, 4)
        assert plan.smem == 4 * 160 * 256 + 4 * 64 * 256 + 4 * 8 * 16 * 4 + 9 * 8 == 231496
        assert affinity.smalln_plan(256, 256, 80, 20, d)[:3] == (160, 1, 2)
        assert affinity.smalln_plan(256, 256, 1, 150, d)[:3] == (8, 1, 8)
        assert affinity.smalln_plan(3, 5, 21, 7, d)[:3] == (88, 1, 4)  # 4 users of 22 columns
        assert affinity.smalln_plan(3, 5, 41, 7, d)[:3] == (88, 1, 2)  # 2 users of 44 columns
        with pytest.raises(ValueError, match="N <= 80"):
            affinity.smalln_plan(256, 256, 81, 20, d)
    for d in (0, affinity.MAX_D + 1):  # widths no plane count takes
        with pytest.raises(ValueError, match="D from 1 to 65536"):
            affinity.smalln_plan(4, 4, 20, 20, d)
    assert affinity.smalln_faster(1) and affinity.smalln_faster(20)
    assert affinity.smalln_faster(80) and not affinity.smalln_faster(81)
    assert not affinity.smalln_faster(150)  # the amazon shape: blocked kernel
    # the blocked kernel: four query slots of ceil8(N) rows, 64-row bank tiles,
    # rows of 128 bf16 columns
    plan = affinity.blocked_plan(256, 256, 150, 150, 128)
    assert (plan.width, plan.chunks, plan.users, plan.groups, plan.slices, plan.peers,
            plan.stages) == (152, 1, 1, 64, 2, 128, 4)
    assert plan.smem == 4 * 152 * 256 + 4 * 64 * 256 + 4 * 128 * 4 + 9 * 8 == 223304
    assert affinity.blocked_plan(4, 6, 300, 300, 128)[:2] == (152, 2)  # two slots a user
    assert affinity.blocked_plan(1, 1, 640, 1, 128)[:2] == (160, 4)
    # beyond four slots a user: KC a multiple of 4, the user's slots in KC / 4 blocks
    assert affinity.blocked_plan(1, 1, 641, 1, 128)[:4] == (88, 8, 1, 2)


PLAN_SHAPES = [  # B, C, N, M, D
    (256, 256, 150, 150, 128), (256, 256, 20, 20, 128), (64, 64, 150, 150, 128),
    (11, 13, 150, 150, 128), (4, 6, 300, 300, 128), (7, 3, 150, 20, 128),
    (5, 7, 33, 9, 32), (3, 4, 17, 24, 16), (1, 1, 1, 1, 128), (9, 5, 40, 48, 64),
    (3, 700, 640, 3, 128), (512, 1000, 161, 7, 64),
    (256, 256, 150, 150, 1024), (256, 256, 20, 20, 1024), (2, 2, 700, 700, 1024),
    (256, 256, 700, 150, 128), (5, 7, 33, 9, 20), (9, 5, 40, 48, 136),
]
SMALLN_PLAN_SHAPES = [  # B, C, N, M, D
    (256, 256, 20, 20, 128), (11, 13, 20, 20, 128), (5, 7, 33, 9, 32), (3, 4, 17, 24, 16),
    (9, 5, 40, 48, 64), (1, 1, 1, 1, 128), (37, 300, 20, 9, 128), (256, 256, 80, 20, 128),
    (3, 5, 7, 64, 128), (1, 1, 1, 150, 128), (512, 1000, 80, 80, 64), (256, 256, 41, 41, 128),
    (256, 256, 20, 20, 1024), (37, 300, 20, 9, 1024), (11, 13, 40, 40, 136),
    (3, 5, 7, 9, 300), (5, 7, 33, 9, 44),
]


def _slice_rows(c, m, peers):
    """Each slice's bank rows and the 64-row tiles a block of it streams."""
    out = []
    for lo in range(0, c, peers):
        row_lo, row_hi = lo * m, min(c, lo + peers) * m
        out.append((row_lo, row_hi, -(-row_hi // 64) - row_lo // 64))
    return out


def _check_grid(plan, c, m):
    """The grid and ring of either plan, counted out: every peer lies in
    exactly one slice and every bank row in a tile of its slice, the bound on
    tiles per block holds, no other slice count gives fewer waves x tiles
    (nor as few with fewer slices), and the ring takes every buffer that
    fits."""
    slices = _slice_rows(c, m, plan.peers)
    assert len(slices) == plan.slices and plan.peers <= affinity.MAX_PEERS
    covered = set()
    for row_lo, row_hi, tiles in slices:
        assert row_lo % m == 0 and row_hi % m == 0  # peer boundaries only
        assert tiles <= affinity.slice_tiles(c, m, plan.peers)
        covered.update(range(row_lo, row_hi))
    assert covered == set(range(c * m))

    def cost(s):
        peers = -(-c // s)
        return (-(-plan.groups * len(_slice_rows(c, m, peers)) // affinity.SM_COUNT)
                * affinity.slice_tiles(c, m, peers))

    counts = range(-(-c // affinity.MAX_PEERS), c + 1)
    best = min(cost(s) for s in counts)
    assert cost(plan.slices) == best
    assert all(len(_slice_rows(c, m, -(-c // s))) >= plan.slices
               for s in counts if cost(s) == best)
    w, dc = plan.width, plan.planes
    assert plan.smem == affinity.affinity_smem_bytes(w, plan.stages, plan.peers, plan.users, dc)
    assert plan.smem <= affinity.SMEM_LIMIT and 2 <= plan.stages <= affinity.MAX_STAGES
    most = max(t for _, _, t in slices) * dc  # items a block streams: a tile's planes each
    assert (plan.stages == affinity.MAX_STAGES or plan.stages >= most
            or affinity.affinity_smem_bytes(w, plan.stages + 1, plan.peers, plan.users, dc)
            > affinity.SMEM_LIMIT)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_blocked_plan_against_a_brute_force_count(shape):
    """The blocked kernel's plan, counted out: the query slots hold every
    query row of every user, and `_check_grid`."""
    b, c, n, m, d = shape
    plan = affinity.blocked_plan(*shape)
    w, kc = plan.width, plan.chunks
    assert plan.users == 1 and plan.planes == -(-d // 128)
    wmax = affinity.MAX_WIDTH if d <= 128 else affinity.CHUNKED_MAX_WIDTH
    assert w % 8 == 0 and w <= wmax and w == -(-(-(-n // kc)) // 8) * 8
    # the fewest chunks a user among 1, 2 and the multiples of 4
    assert kc in (1, 2) or kc % 4 == 0
    assert all(-(-n // k) > wmax for k in (1, 2, *range(4, kc, 4)) if k < kc)
    assert plan.groups * affinity.SLOTS >= b * kc > (plan.groups - 1) * affinity.SLOTS
    # slot s holds chunk s % kc of user s // kc: every (user, row) once
    held = {(s // kc, (s % kc) * w + j) for s in range(b * kc) for j in range(w)
            if (s % kc) * w + j < n}
    assert len(held) == b * n
    _check_grid(plan, c, m)


@pytest.mark.parametrize("shape", SMALLN_PLAN_SHAPES)
def test_smalln_plan_against_a_brute_force_count(shape):
    """The small-N kernel's plan, counted out: the most users a slot whose
    columns fit in 160, a slot wide enough for all of each user's rows, just
    enough groups for every user, and `_check_grid`."""
    b, c, n, m, d = shape
    plan = affinity.smalln_plan(*shape)
    w, u = plan.width, plan.users
    wmax = affinity.MAX_WIDTH if d <= 128 else affinity.CHUNKED_MAX_WIDTH
    assert plan.chunks == 1 and u in affinity.SMALLN_USERS and plan.planes == -(-d // 128)
    assert w % 8 == 0 and w <= wmax and w == -(-n * u // 8) * 8
    assert w // u >= n  # 8 / U column places in each group of 8, w / 8 groups
    assert all(-(-n * k // 8) * 8 > wmax for k in affinity.SMALLN_USERS if k > u)
    assert plan.groups * affinity.SLOTS * u >= b > (plan.groups - 1) * affinity.SLOTS * u
    _check_grid(plan, c, m)


def _slot_columns(plan, b, n, group):
    """What pack_kernel writes into a block's four slots and whose maximum
    each column feeds in the fold (csrc/affinity.cu): for every column of the
    block, (the block's user the fold gives it, the user and the row whose
    values the pack puts there)."""
    u, kc, w = plan.users, plan.chunks, plan.width
    places = 8 // u  # column places of one user in each group of 8 (K7)
    out = []
    for k in range(affinity.SLOTS):
        s = group * affinity.SLOTS + k
        for col in range(w):
            q = col % 8
            user = (s // kc) * u + q // places
            row = (s % kc) * w + (col // 8) * places + q % places
            fold_user = k // kc if u == 1 else k * u + q // places
            out.append((fold_user, min(user, b - 1), min(row, n - 1), user, row))
    return out


def _fold_rows(plan, c, m, row_lo, row_hi):
    """(bank row, peer) pairs a block folds: tile by tile, 16 rows a warp,
    a peer at a time where the warp's rows lie in one or two peers, else row
    by row; rows outside the slice skipped."""
    pairs = []
    t_lo = row_lo // 64
    for tile in range(t_lo, -(-row_hi // 64)):
        for warp in range(4):
            first = tile * 64 + warp * 16
            lo, hi = max(first, row_lo), min(first + 16, row_hi)
            if lo >= hi:
                continue
            p_lo, p_hi = lo // m, (hi - 1) // m
            if p_hi - p_lo <= 1:
                pairs += [(r, p) for p in (p_lo, p_hi)[:p_hi - p_lo + 1]
                          for r in range(max(p * m, lo), min(p * m + m, hi))]
            else:
                pairs += [(r, r // m) for r in range(lo, hi)]
    return pairs


WALK_SHAPES = [  # kernel, (B, C, N, M)
    ("smalln", (37, 300, 20, 9)), ("smalln", (5, 7, 33, 9)), ("smalln", (3, 5, 7, 64)),
    ("smalln", (1, 1, 1, 150)), ("smalln", (11, 13, 20, 20)), ("smalln", (9, 70, 50, 3)),
    ("blocked", (5, 7, 33, 9)), ("blocked", (4, 6, 300, 300)), ("blocked", (3, 40, 170, 5)),
]


@pytest.mark.parametrize("kernel,shape", WALK_SHAPES)
def test_the_plan_s_schedule_walked_on_the_cpu(rng, kernel, shape):
    """Both kernels' schedule emulated block by block from the plan: query
    slots (K7: several users a slot, interleaved), 64-row bank tiles,
    slices of the peers, the fold's row windows. Every out[b, c] is written
    by exactly one block, every bank row of a slice is folded once by each
    block of the slice, every padding column holds a real row of the user
    whose maximum it feeds, and the emulated result is the exact maximum of
    the same scores."""
    b, c, n, m = shape
    plan = (affinity.smalln_plan if kernel == "smalln" else affinity.blocked_plan)(
        b, c, n, m, 128)
    scores = rng.normal(size=(b * n, c * m))
    want = scores.reshape(b, n, c, m).max(axis=(1, 3))
    out = np.full((b, c), np.nan)
    written = np.zeros((b, c), int)
    per_block = affinity.SLOTS * plan.users // plan.chunks
    for group in range(plan.groups):
        cols = _slot_columns(plan, b, n, group)
        held = set()
        for fold_user, user, row, packed_user, packed_row in cols:
            # the fold's user is the pack's; padding past the last user or
            # row repeats a real row of that same user
            assert group * per_block + fold_user == packed_user
            assert user == min(packed_user, b - 1) and row == min(packed_row, n - 1)
            held.add((packed_user, row))
        assert {(u, r) for u in range(group * per_block, min(b, (group + 1) * per_block))
                for r in range(n)} <= held
        fold_users = np.array([f for f, *_ in cols])
        sources = np.array([u * n + r for _, u, r, _, _ in cols])
        for c_lo in range(0, c, plan.peers):
            c_hi = min(c, c_lo + plan.peers)
            pairs = _fold_rows(plan, c, m, c_lo * m, c_hi * m)
            rows = np.array([r for r, _ in pairs])
            assert sorted(rows.tolist()) == list(range(c_lo * m, c_hi * m))
            assert all(p == r // m for r, p in pairs)
            table = np.full((affinity.SLOTS * plan.users, plan.peers), -np.inf)
            peers = np.array([p for _, p in pairs]) - c_lo
            np.maximum.at(table, (fold_users[:, None], peers[None, :]),
                          scores[sources][:, rows])
            for lu in range(per_block):
                user = group * per_block + lu
                if user < b:
                    out[user, c_lo:c_hi] = table[lu, :c_hi - c_lo]
                    written[user, c_lo:c_hi] += 1
    assert (written == 1).all()
    np.testing.assert_array_equal(out, want)


# ---------------------------------------------------------------------------
# scoring head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(256, 1000, 128, 32), (256, 2, 128, 32), (7, 37, 64, 8),
                                   (2, 130, 256, 64), (3, 1, 128, 33), (100000, 1, 128, 32),
                                   (0, 5, 32, 8), (1, 1, 4, 1)])
def test_scoring_plan_against_a_brute_force_count(shape):
    """The scoring kernel's plan, counted out: the blocks' contiguous tile
    ranges cover every candidate row once and no block is empty, the blocks
    fill the card at most once over, and the shared memory is the kernel's
    formula within the limit."""
    b, c, d, h = shape
    plan = scoring.scoring_plan(*shape)
    rows = b * c
    assert plan.tiles == -(-rows // 64)
    covered = []
    for block in range(plan.grid):
        first = block * plan.tiles_per_block
        tiles = range(first, min(plan.tiles, first + plan.tiles_per_block))
        assert len(tiles) > 0
        covered += [r for t in tiles for r in range(t * 64, min(rows, t * 64 + 64))]
    assert covered == list(range(rows))
    per_sm = max(1, 233472 // (plan.smem + 1024))
    assert plan.grid <= scoring.SM_COUNT * per_sm
    assert plan.smem == scoring.scoring_smem_bytes(d, h) <= scoring.SMEM_LIMIT
    assert scoring.user_half_smem_bytes(d, h) <= scoring.SMEM_LIMIT


def _head_inputs(rng, b, c, d=128, h=32):
    """user, items and the head's parameters in torch's layout ([H, 2D] first
    layer, [1, H] second), beside the JAX kernels' [D, H] / [H, 1] views."""
    user, items = _normal(rng, b, d), _normal(rng, b, c, d)
    fc1 = _normal(rng, h, 2 * d, scale=0.05)
    b1, w2, b2 = _normal(rng, h, scale=0.05), _normal(rng, 1, h, scale=0.1), \
        _normal(rng, 1, scale=0.1)
    jax_args = tuple(map(jnp.asarray, (user, items, fc1[:, :d].T, fc1[:, d:].T, b1, w2.T, b2)))
    return (user, items, fc1, b1, w2, b2), jax_args


@pytest.mark.parametrize("c", [200, 2])
def test_scoring_head_forward_matches_the_pallas_kernel(rng, c):
    (user, items, fc1, b1, w2, b2), jax_args = _head_inputs(rng, 4, c)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(scoring_head_pallas(*jax_args))
    d = user.shape[1]
    w = torch.as_tensor(fc1)
    args = (torch.as_tensor(user), torch.as_tensor(items), w[:, :d], w[:, d:],
            torch.as_tensor(b1), torch.as_tensor(w2), torch.as_tensor(b2))
    before = scoring.scoring_head.launches
    for fn in (scoring.scoring_head_plain, scoring.scoring_head):
        got = fn(*args)
        assert tuple(got.shape) == (4, c)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert scoring.scoring_head.launches == before


@pytest.mark.parametrize("which", ["function", "plain"])
def test_scoring_head_gradients_match_the_pallas_vjp(rng, which):
    """All seven gradients of sum(out ** 2): the Function's hand-written
    backward and autograd through the plain version, against the JAX
    custom_vjp. The halves of fc1 are views of one leaf, so its gradient is
    both halves' side by side. rtol 1e-4 / atol 1e-5 (sums over B*C)."""
    (user, items, fc1, b1, w2, b2), jax_args = _head_inputs(rng, 4, 130)

    def jax_loss(*a):
        return jnp.sum(scoring_head_pallas(*a) ** 2)

    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(g) for g in jax.grad(jax_loss, argnums=tuple(range(7)))(*jax_args)]
    d = user.shape[1]
    leaves = [torch.tensor(x, requires_grad=True) for x in (user, items, fc1, b1, w2, b2)]
    u, it, w, tb1, tw2, tb2 = leaves
    fn = scoring.scoring_head if which == "function" else scoring.scoring_head_plain
    out = fn(u, it, w[:, :d], w[:, d:], tb1, tw2, tb2)
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    duser, ditems, dku, dki, db1, dk2, db2 = want
    want_torch = [duser, ditems, np.concatenate([dku.T, dki.T], axis=1), db1, dk2.T, db2]
    for name, g, w_ in zip(("user", "items", "fc1", "b1", "w2", "b2"), got, want_torch):
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-4, atol=1e-5, err_msg=name)


def test_scoring_head_refuses_wrong_shapes(rng):
    (user, items, fc1, b1, w2, b2), _ = _head_inputs(rng, 3, 5, d=16, h=4)
    w = torch.as_tensor(fc1)
    ok = [torch.as_tensor(user), torch.as_tensor(items), w[:, :16], w[:, 16:],
          torch.as_tensor(b1), torch.as_tensor(w2), torch.as_tensor(b2)]
    scoring.scoring_head(*ok)
    with pytest.raises(ValueError, match="w2 must be"):
        scoring.scoring_head(*ok[:5], ok[5].T, ok[6])
    with pytest.raises(ValueError, match=r"items \[B, C, D\]"):
        scoring.scoring_head(ok[0], ok[1][:2], *ok[2:])
    with pytest.raises(TypeError, match="float32"):
        scoring.scoring_head(ok[0].double(), *ok[1:])
    # the kernel's plan: 64-row tiles of the B * C candidates in contiguous ranges
    assert scoring.scoring_plan(256, 1000, 128, 32) == (4000, 8, 500, 52352)
    assert scoring.scoring_plan(256, 2, 128, 32)[:3] == (8, 1, 8)
    assert scoring.scoring_plan(4, 1000, 128, 32)[:3] == (63, 1, 63)
    # every (D, H) has a plan: Wi^T beyond a block takes the wide kernel
    assert scoring.scoring_plan(1, 1, 1024, 64) == (1, 1, 1, 103552)
    assert scoring.scoring_kernel(1024, 64) == "wide"


# ---------------------------------------------------------------------------
# embedding gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_embedding_gather_matches_the_pallas_kernel(rng, dtype):
    table = _normal(rng, 64, 128)
    ids = rng.integers(0, 64, (5, 7)).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(embedding_gather_pallas(jnp.asarray(table),
                                                  jnp.asarray(ids.astype(np.int32))))
    before = embedding.embedding_gather.launches
    for fn in (embedding.embedding_gather_plain, embedding.embedding_gather):
        got = fn(torch.as_tensor(table), torch.as_tensor(ids))
        np.testing.assert_array_equal(got.numpy(), want)  # a copy: exact
    assert embedding.embedding_gather.launches == before


@pytest.mark.parametrize("which", ["function", "plain"])
def test_embedding_gather_gradient_is_a_scatter_add(rng, which):
    """Duplicated ids add up, in the Function's backward and in autograd's
    through the plain version, as in the JAX custom_vjp."""
    table, w = _normal(rng, 16, 8), _normal(rng, 2, 3, 8)
    ids = np.array([[0, 3, 3], [15, 3, 0]], np.int32)

    def jax_loss(t):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(embedding_gather_pallas(t, jnp.asarray(ids)) * jnp.asarray(w))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(table)))
    t = torch.tensor(table, requires_grad=True)
    fn = embedding.embedding_gather if which == "function" else embedding.embedding_gather_plain
    (got,) = torch.autograd.grad((fn(t, torch.as_tensor(ids)) * torch.as_tensor(w)).sum(), t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert np.count_nonzero(got.numpy().any(axis=1)) == 3  # rows 0, 3, 15 only


def test_embedding_gather_clamps_ids_outside_the_table(rng):
    """What the kernel does on the card (it never reads out of bounds), the
    plain version does too: an id outside [0, V) reads the nearest row, and
    its gradient lands there. The lazy step's searchsorted position U for an
    id above every unique id is that case."""
    table = torch.tensor(_normal(rng, 10, 4), requires_grad=True)
    ids = torch.tensor([-3, 0, 9, 10, 12])
    want = table.detach()[torch.tensor([0, 0, 9, 9, 9])]
    for fn in (embedding.embedding_gather, embedding.embedding_gather_plain):
        out = fn(table, ids)
        assert torch.equal(out.detach(), want)
        (g,) = torch.autograd.grad(out.sum(), table)
        assert g[0].tolist() == [2.0] * 4 and g[9].tolist() == [3.0] * 4
        assert torch.count_nonzero(g[1:9]) == 0
    uids = torch.tensor([2, 5, 7, 10, 10])  # sorted unique ids, sentinel tail V=10
    rows = table.detach()[uids.clamp(max=9)]
    pos = torch.searchsorted(uids, torch.tensor([5, 7, 2, 11]))
    assert pos.tolist() == [1, 2, 0, 5]  # 11 > sentinel: position U, clamped to U - 1
    assert torch.equal(embedding.embedding_gather(rows, pos), rows[[1, 2, 0, 4]])
    with pytest.raises(TypeError, match="int32 or int64"):
        embedding.embedding_gather(table, ids.float())
