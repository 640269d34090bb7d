"""The port's data layer against the JAX package's: `pack_rows`, the CSV
readers (native and Python) and `BatchIterator` bit-equal on synthetic
input; the negative sampler exact (never a hole, never outside the pool,
equal to the literal skip-sorted-holes loop) and uniform within 3 sigma."""

import csv
import json
import logging

import numpy as np
import pytest
import torch

from amid_tpu.data import loader as jax_loader
from amid_tpu.data import native as jax_native
from amid_tpu.data import packed as jax_packed
from amid_tpu_torch.data import loader, native, packed
from amid_tpu_torch.data.sampler import sample_negatives


def _rows(rng, n, n_items, max_len=9):
    users, s1, s2, dom = [], [], [], []
    for i in range(n):
        users.append(i)
        d = int(rng.integers(0, 2))
        l1 = int(rng.integers(0 if d else 1, max_len))
        l2 = int(rng.integers(1 if d else 0, max_len))
        dom.append(d)
        s1.append(rng.integers(1, n_items, l1).tolist())
        s2.append(rng.integers(n_items, 2 * n_items, l2).tolist())
    return users, s1, s2, dom, rng.integers(0, 2, n).tolist()


def _assert_same_dataset(a, b):
    assert (a.pad_id, a.seq_len, len(a)) == (b.pad_id, b.seq_len, len(b))
    for k, v in b.batch_arrays().items():
        got = a.batch_arrays()[k]
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)
    np.testing.assert_array_equal(a.pools, b.pools)
    np.testing.assert_array_equal(a.pool_sizes, b.pool_sizes)


@pytest.fixture
def rows():
    return _rows(np.random.default_rng(0), 50, 30)


@pytest.mark.parametrize("with_ob", [True, False])
def test_pack_rows_bit_equal(rows, with_ob):
    users, s1, s2, dom, ob = rows
    args = (users, s1, s2, dom, ob if with_ob else None, 6, 61, 4)
    _assert_same_dataset(packed.pack_rows(*args), jax_packed.pack_rows(*args))


@pytest.mark.parametrize("seq,want", [([1, 2, 3], [9, 9, 1, 2, 3]),
                                      ([1, 2, 3, 4, 5, 6], [2, 3, 4, 5, 6]), ([], [9] * 5)])
def test_seq_pad_trunc(seq, want):
    assert packed.seq_pad_trunc(seq, 5, 9) == want == jax_packed.seq_pad_trunc(seq, 5, 9)


@pytest.mark.parametrize("subdomain", [None, 1])
def test_csv_reader_bit_equal_and_save_load(tmp_path, rows, subdomain):
    users, s1, s2, dom, ob = rows
    path = tmp_path / "d.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["user_id", "seq_d1", "seq_d2", "domain_id", "ob_label"])
        for r in zip(users, s1, s2, dom, ob):
            w.writerow([r[0], json.dumps(r[1]), json.dumps(r[2]), r[3], r[4]])
    got = packed.load_dual_domain_csv(str(path), 6, 61, 4, with_ob_label=True,
                                      subdomain=subdomain)
    want = jax_packed.load_dual_domain_csv(str(path), 6, 61, 4, with_ob_label=True,
                                           subdomain=subdomain)
    _assert_same_dataset(got, want)
    got.save(str(tmp_path / "ds.npz"))
    _assert_same_dataset(packed.PackedDualDomainDataset.load(str(tmp_path / "ds.npz")), want)


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["user_id", "seq_d1", "seq_d2", "domain_id", "ob_label"])
        for r in zip(*rows):
            w.writerow([r[0], json.dumps(r[1]), json.dumps(r[2]), r[3], r[4]])


@pytest.mark.parametrize("with_ob", [True, False])
def test_native_reader_equals_the_jax_package_s_and_pack_rows(tmp_path, rows, with_ob):
    """`pack_csv_native` and `parse_csv_native` of the port against the JAX
    package's bindings of the same library, and against the Python reader
    and `pack_rows`, array by array (`amid_tpu/data/native.py:73,130`)."""
    path = str(tmp_path / "d.csv")
    _write_csv(path, rows)
    assert native.library_path() is not None
    got = native.pack_csv_native(path, with_ob, 6, 61, 4)
    _assert_same_dataset(got, jax_native.pack_csv_native(path, with_ob, 6, 61, 4))
    python = packed.read_csv_python(path, with_ob)
    assert native.parse_csv_native(path, with_ob) == jax_native.parse_csv_native(
        path, with_ob) == python
    _assert_same_dataset(got, packed.pack_rows(*python[:4], python[4] if with_ob else None,
                                               6, 61, 4))
    _assert_same_dataset(packed.load_dual_domain_csv(path, 6, 61, 4, with_ob), got)


@pytest.mark.parametrize("builds", [True, False], ids=["built", "python"])
def test_native_reader_builds_into_build_or_falls_back_to_python(tmp_path, rows, monkeypatch,
                                                                 builds):
    """Where the tracked library does not load, csv_parser.cpp is built with
    the Makefile's flags into the port's build directory (never native/);
    where that fails too, the warning names the library once and the
    Python reader gives the same dataset."""
    makefile = (native._NATIVE_DIR / "Makefile").read_text()
    assert f"CXXFLAGS ?= {' '.join(native.CXXFLAGS)}" in makefile
    path = str(tmp_path / "d.csv")
    _write_csv(path, rows)
    want = packed.load_dual_domain_csv(path, 6, 61, 4, True)
    monkeypatch.setattr(native, "_SO", tmp_path / "missing.so")
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    if not builds:
        monkeypatch.setenv("CXX", str(tmp_path / "no-compiler"))
    said = []  # the module's own logger: init_logger may stop propagation above it
    handler = logging.Handler()
    handler.emit = lambda record: said.append(record.getMessage())
    native.log.addHandler(handler)
    native._load.cache_clear()
    try:
        lib = native.library_path()
        if builds:
            assert lib == tmp_path / "_build" / "libamid_native.so"
            assert [p.name for p in (tmp_path / "_build").iterdir()] == [lib.name]
        else:
            assert lib is None
            assert native.pack_csv_native(path, True, 6, 61, 4) is None
            assert sum("missing.so" in m for m in said) == 1
        native.library_path()
        _assert_same_dataset(packed.load_dual_domain_csv(path, 6, 61, 4, True), want)
        assert sum("missing.so" in m for m in said) == (0 if builds else 1)
    finally:
        native.log.removeHandler(handler)
        native._load.cache_clear()


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_batch_iterator_bit_equal(rows, shuffle, drop_last):
    ds = packed.pack_rows(*rows, 6, 61)
    jds = jax_packed.pack_rows(*rows, 6, 61)
    it = loader.BatchIterator(ds, 8, shuffle, seed=3, drop_last=drop_last)
    jit = jax_loader.BatchIterator(jds, 8, shuffle, seed=3, drop_last=drop_last)
    assert len(it) == len(jit) == (6 if drop_last else 7)
    for _ in range(2):  # two epochs: the rng stream advances alike
        for got, want in zip(it, jit, strict=True):
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(it.epoch_perm(), jit.epoch_perm())
    if drop_last:
        got, want = it.stacked(), jit.stacked()  # one permutation each
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert it.arrays().keys() == jit.arrays().keys()


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

def _loop_sampler(j, reject):
    """The literal ascending pass of the JAX package, in numpy."""
    idx = j.copy()
    for r in range(reject.shape[1]):
        idx = idx + (reject[:, r][:, None] <= idx)
    return idx


@pytest.fixture
def sampler_ds():
    rng = np.random.default_rng(1)
    return packed.pack_rows(*_rows(rng, 40, 25, max_len=12), 6, 51)


def _draw(ds, num_neg, seed=0, with_counts=True):
    gen = torch.Generator().manual_seed(seed)
    t = {k: torch.as_tensor(v) for k, v in ds.batch_arrays().items()}
    return sample_negatives(
        gen, torch.as_tensor(ds.pools), torch.as_tensor(ds.pool_sizes), t["domain_id"],
        t["reject"], num_neg, t["reject_counts"] if with_counts else None).numpy()


def test_sampler_never_draws_a_hole_or_leaves_the_pool(sampler_ds):
    ds = sampler_ds
    neg = _draw(ds, 600)
    assert neg.shape == (len(ds), 600) and neg.dtype == np.int32
    for i in range(len(ds)):
        d = ds.domain_id[i]
        pool = ds.pools[d][: ds.pool_sizes[d]]
        holes = set(pool[ds.reject[i][: ds.reject_counts[i]]].tolist())
        valid = set(pool.tolist()) - holes
        drawn = set(neg[i].tolist())
        assert drawn <= valid, f"row {i}: drew outside the valid set"
        assert drawn == valid, f"row {i}: {valid - drawn} never drawn in 600"
    np.testing.assert_array_equal(neg, _draw(ds, 600, with_counts=False))


def test_sampler_closed_form_equals_the_literal_loop(sampler_ds):
    """Every j in [0, valid) maps where the ascending pass maps it, with a
    sentinel tail wider than the pool's slack (the tail is where a closed form
    without the mask goes wrong)."""
    ds = sampler_ds
    p = ds.pools.shape[1]
    tail = np.full((len(ds), 3 * p), p, np.int32)
    reject = np.concatenate([ds.reject, tail], axis=1)
    counts = torch.as_tensor(ds.reject_counts)
    valid = ds.pool_sizes[ds.domain_id] - ds.reject_counts
    j = np.stack([np.arange(valid.max()) % v for v in valid])  # [B, maxvalid]
    k = torch.arange(reject.shape[1])
    g = torch.where(k[None] < counts[:, None], torch.as_tensor(reject).long() - k,
                    torch.iinfo(torch.int32).max)
    got = torch.as_tensor(j) + torch.searchsorted(g, torch.as_tensor(j), right=True)
    np.testing.assert_array_equal(got.numpy(), _loop_sampler(j, reject))


def test_sampler_uniform_within_3_sigma(sampler_ds):
    ds = sampler_ds
    n = 20000
    neg = _draw(ds, n, seed=7)
    for i in (0, 5, 11):
        d = ds.domain_id[i]
        nvalid = int(ds.pool_sizes[d] - ds.reject_counts[i])
        _, counts = np.unique(neg[i], return_counts=True)
        assert len(counts) == nvalid
        pr = 1.0 / nvalid
        sigma = np.sqrt(n * pr * (1 - pr))
        # 3 sigma per bin would fail 0.3% of bins by chance; the seed is fixed
        assert np.abs(counts - n * pr).max() <= 3.5 * sigma


def test_sampler_same_generator_state_same_draw(sampler_ds):
    np.testing.assert_array_equal(_draw(sampler_ds, 50, seed=4), _draw(sampler_ds, 50, seed=4))
    assert not np.array_equal(_draw(sampler_ds, 50, seed=4), _draw(sampler_ds, 50, seed=5))


def test_synth_packed_has_real_size_pools_and_consistent_holes():
    """The synthetic dataset of the scripts that run on the card: pools are every id of each half
    of the table, holes are positions in them of the user's own items, and
    the sampler never returns one of those."""
    from amid_tpu_torch.config import ModelConfig
    from amid_tpu_torch.data.synthetic import synth_packed

    cfg = ModelConfig(seq_len=6, item_length=300)
    ds = synth_packed(cfg, np.random.default_rng(0), 40)
    assert ds.pool_sizes.tolist() == [301, 298] and ds.pools.shape == (2, 301)
    assert ds.pools[0, 0] == 0 and ds.pools[1, 0] == cfg.pad_id + 1
    assert not np.isin(cfg.pad_id, ds.pools)
    for i in range(len(ds)):
        d, n = ds.domain_id[i], ds.reject_counts[i]
        holes = ds.pools[d][ds.reject[i, :n]]
        assert (np.diff(ds.reject[i, :n]) > 0).all() and (ds.reject[i, n:] == 301).all()
        assert ds.target[i] in holes
        seq = (ds.seq_d1 if d == 0 else ds.seq_d2)[i]
        assert set(seq[seq != cfg.pad_id].tolist()) <= set(holes.tolist())
    neg = _draw(ds, 400)
    for i in range(len(ds)):
        d = ds.domain_id[i]
        holes = set(ds.pools[d][ds.reject[i, : ds.reject_counts[i]]].tolist())
        assert not holes & set(neg[i].tolist())
        assert set(neg[i].tolist()) <= set(ds.pools[d][: ds.pool_sizes[d]].tolist())
