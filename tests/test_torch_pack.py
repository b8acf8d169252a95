"""The index pack of fora_tpu_torch on the CPU: ``pack_index_plain`` (the
plain version of K7, ``kernels/csrc/pack.cu``: keys by tensor arithmetic,
``torch.sort``, ``unique_consecutive``) and ``pack_index``'s branches
against the JAX package's ``pack_index`` in each of its three branches
(its native radix sort, ``fora_tpu/_native/radix_sort.cpp``; its numpy
packed-key sort; its legacy lexsort, merged by ``dedup_index``), on the
smoke graph's counts and on the edge cases of ``pack_cases.py`` (no
dangling node, every node dangling so no walk at all, one walk a node,
runs of one key across K7's tiles, a digit the same in every key, many
tiles); and K7's refusal of a pack that does not fit, before any launch.
The card's kernels are held to the same plain version bit for bit by
``test_torch_kernels_cuda.py -k pack``."""

import numpy as np
import pytest
import torch
from pack_cases import NAMES, case, smoke

from fora_tpu import _native
from fora_tpu import index as jax_index
from fora_tpu.config import ForaConfig as JaxConfig
from fora_tpu_torch import ForaConfig, kernels
from fora_tpu_torch.index import build as ib

torch.set_num_threads(2)

ARRAYS = ("edge_src", "edge_dst", "counts_cum", "edge_mult",
          "bucket_offsets")


def _rcfgs(n: int, m: int):
    return (ForaConfig(epsilon=0.5, k=50).resolved(n, m),
            JaxConfig(epsilon=0.5, k=50).resolved(n, m))


def assert_same(ours, theirs) -> None:
    for f in ARRAYS:
        a, b = getattr(ours, f), getattr(theirs, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f)
    assert ours.omega_unit_built == theirs.omega_unit_built
    assert ours.rmax_built == theirs.rmax_built


def _smoke():
    rcfg, jrcfg = _rcfgs(4096, 32768)
    ends, counts, deg = smoke(lambda d: ib.index_counts(d, rcfg))
    return ends, counts, deg, rcfg, jrcfg


@pytest.mark.parametrize("branch", ["native", "numpy", "legacy"])
def test_plain_pack_matches_jax(branch, monkeypatch):
    """``pack_index_plain`` against JAX's branch ``branch``; with the
    legacy branch also the port's own legacy branch (dedup off) against
    JAX's, array for array."""
    ends, counts, deg, rcfg, jrcfg = _smoke()
    if branch == "native":
        assert _native.native_sort_unique_u64 is not None
    else:
        monkeypatch.setattr(_native, "native_sort_unique_u64", None)
    ours = ib.pack_index_plain(torch.from_numpy(ends), counts, deg, rcfg)
    if branch == "legacy":
        raw = jax_index.pack_index(ends, counts, deg, jrcfg, dedup=False)
        theirs = jax_index.dedup_index(raw)
        mine = ib.pack_index(ends, counts, deg, rcfg, dedup=False)
        assert mine.edge_mult is None
        for f in ("edge_src", "edge_dst", "counts_cum", "bucket_offsets"):
            np.testing.assert_array_equal(getattr(mine, f),
                                          np.asarray(getattr(raw, f)))
    else:
        theirs = jax_index.pack_index(ends, counts, deg, jrcfg)
    assert_same(ours, theirs)
    assert float(ours.edge_mult.sum()) == counts.sum() + (deg == 0).sum()


@pytest.mark.parametrize("name", NAMES)
def test_plain_pack_edge_cases_match_jax(name):
    """Each edge case: ``pack_index_plain`` and ``pack_index`` on a numpy
    and on a CPU tensor argument array-equal to JAX's native pack."""
    ends, counts, deg = case(name)
    rcfg, jrcfg = _rcfgs(len(deg), max(int(deg.sum()), 1))
    theirs = jax_index.pack_index(ends, counts, deg, jrcfg)
    assert_same(ib.pack_index_plain(torch.from_numpy(ends), counts, deg,
                                    rcfg), theirs)
    assert_same(ib.pack_index(ends, counts, deg, rcfg), theirs)
    assert_same(ib.pack_index(torch.from_numpy(ends), counts, deg, rcfg),
                theirs)


def test_plain_parts():
    """The plain pieces alone on the long-runs case: the keys decode to
    each entry's node, endpoint and the bucket of its place in the node's
    pool; the sort is ascending; the merge's multiplicities add up to the
    keys and its bucket counts to the unique edges."""
    ends, counts, deg = case("long_runs")
    t = ib.pack_tables(counts, deg)
    offsets, cut, dang = (torch.from_numpy(a)
                          for a in (t.offsets, t.cut, t.dang))
    keys = ib.pack_keys_plain(torch.from_numpy(ends), offsets, cut, dang,
                              t.nb)
    assert keys.shape == (t.keys,) and keys.dtype == torch.int64
    mask = (1 << t.nb) - 1
    src = np.repeat(np.arange(len(counts)), counts)
    k = keys[:t.total].numpy()
    np.testing.assert_array_equal(k & mask, src)
    np.testing.assert_array_equal((k >> t.nb) & mask, ends)
    j = np.arange(t.total) - t.offsets[src]
    bucket = sum((j < t.cut[src, q]).astype(np.int64)
                 for q in range(1, ib.NUM_BUCKETS))
    np.testing.assert_array_equal(k >> (2 * t.nb), bucket)
    s = ib.sort_keys_plain(keys)
    assert bool((s[1:] >= s[:-1]).all())
    src_u, dst_u, mult, bc = ib.merge_keys_plain(s, t.nb)
    assert float(mult.sum()) == t.keys and int(bc.sum()) == len(src_u)
    assert float(mult.max()) >= 30000 - 30000 // 4   # node 5's bucket 0 run


def test_pack_refuses_before_any_launch(monkeypatch):
    """A pack larger than the device's free memory refuses with the bytes
    it needed, before K7-keys is launched; the bytes are 28 a key, the
    scratch and the tables."""
    ends, counts, deg = case("no_dangling")
    t = ib.pack_tables(counts, deg)
    need = ib.pack_bytes(t)
    assert need == (28 * t.keys + 4 * kernels.sort_scratch_words(t.keys)
                    + 4 * (-(-t.keys // kernels.PACK_TILE) + 1)
                    + 72 * len(counts) + 8 * len(t.dang))
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (need - 1, 1 << 40))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: 0)

    def launched(*a, **kw):
        raise AssertionError("K7 launched")
    monkeypatch.setattr(kernels, "pack_keys", launched)
    with pytest.raises(torch.OutOfMemoryError, match=f"needs {need} bytes"):
        ib._pack_on_card(torch.from_numpy(ends), t,
                         ib._splitter(None, "cpu"), True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (need, 1 << 40))
    ib.check_pack_fits(need, "cuda:0")


def test_earlier_numpy_form_equals_plain():
    """``probes/pack_earlier.py`` (the numpy packed-key branch the port ran
    before K7, which ``chip_smoke.py`` times beside K7) equals the plain
    pack and JAX's native pack."""
    from fora_tpu_torch.probes.pack_earlier import pack_index_numpy
    ends, counts, deg, rcfg, jrcfg = _smoke()
    got = pack_index_numpy(ends, counts, deg, rcfg)
    assert_same(got, ib.pack_index_plain(torch.from_numpy(ends), counts, deg,
                                         rcfg))
    assert_same(got, jax_index.pack_index(ends, counts, deg, jrcfg))


@pytest.mark.parametrize("name", ["long_runs", "single_walk", "many_tiles"])
def test_bucket_pointers_equal_dst_indptr(name):
    """``with_indptr``'s pointers (a bincount and a running sum) equal
    ``graph.csr.dst_indptr``'s searchsorted in every bucket of a pack, and
    on a bucket whose endpoints are all the last node or all node 0."""
    from fora_tpu_torch.graph.csr import dst_indptr
    ends, counts, deg = case(name)
    rcfg, _ = _rcfgs(len(deg), max(int(deg.sum()), 1))
    idx = ib.pack_index(ends, counts, deg, rcfg)
    n = len(counts)
    for q in range(ib.NUM_BUCKETS):
        lo, hi = idx.bucket_offsets[q], idx.bucket_offsets[q + 1]
        got = idx.dst_indptr[q]
        if hi == lo:
            assert got is None
            continue
        want = dst_indptr(idx.edge_dst[lo:hi], n)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    for dst in (np.full(5, n - 1, np.int32), np.zeros(7, np.int32)):
        np.testing.assert_array_equal(ib._endpoint_indptr(dst, n),
                                      dst_indptr(dst, n))
