"""The index pack of fora_tpu_torch on the CPU: ``pack_index_plain`` (the
plain version of K7, ``kernels/csrc/pack.cu``: keys by tensor arithmetic,
``torch.sort``, ``unique_consecutive``) and ``pack_index``'s branches
against the JAX package's ``pack_index`` in each of its three branches
(its native radix sort, ``fora_tpu/_native/radix_sort.cpp``; its numpy
packed-key sort; its legacy lexsort, merged by ``dedup_index``), on the
smoke graph's counts and on the edge cases of ``pack_cases.py`` (no
dangling node, every node dangling so no walk at all, one walk a node,
runs of one key across K7's tiles, a digit the same in every key, one
node, empty buckets between full ones, many tiles, a node across several
of K7-keys' tiles, a run of empty nodes longer than a tile); the buckets'
row pointers that K7-merge's plain version counts against
``with_indptr``'s; K7's scratch and its refusal of a pack that does not
fit, before any launch; the integer cutoffs K7-keys forms on the card
against the host's float64 table; and K7-keys', K7-sort's and K7-merge's
algorithms (``kernels/csrc/pack.cu``) emulated lane by lane in numpy, at
the card's tiles and at small ones, against the plain versions.  The
card's kernels are held to the same plain version bit for bit by
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
    src_u, dst_u, mult, bc, ptr = ib.merge_keys_plain(s, t.nb,
                                                      len(counts))
    assert float(mult.sum()) == t.keys and int(bc.sum()) == len(src_u)
    assert float(mult.max()) >= 30000 - 30000 // 4   # node 5's bucket 0 run
    assert ptr.shape == (ib.NUM_BUCKETS, len(counts) + 1)
    assert ptr.dtype == torch.int32
    np.testing.assert_array_equal(ptr[:, -1].numpy(), bc.numpy())


def test_pack_refuses_before_any_launch(monkeypatch):
    """A pack larger than the device's free memory goes in key-range
    windows, each within the free bytes, and equals JAX's pack; it is
    refused, with the bytes its smallest window needs, only where a window
    of one key does not fit, before any launch.  The bytes of one sort are
    28 a key, the sort's and the merge's scratch, the buckets' row
    pointers, K7-keys' tables (offsets [n + 1], the dangling nodes) and the
    digit counts it hands the sort; a window's also the windows' running
    sum of the pointers, the count form's bins and the window form's
    cursor."""
    ends, counts, deg = case("no_dangling")
    t = ib.pack_tables(counts, deg)
    need = ib.pack_bytes(t)
    digits = 9 if -(-(2 * t.nb + 4) // 9) < -(-(2 * t.nb + 4) // 8) else 8
    assert kernels.sort_digit_bits(2 * t.nb + 4) == digits
    assert need == (28 * t.keys + 4 * kernels.sort_scratch_words(t.keys,
                                                                 digits)
                    + 4 * kernels.merge_scratch_words(t.keys, len(counts))
                    + 4 * 8 * (len(counts) + 1)
                    + 8 * (len(counts) + 1) + 8 * len(t.dang)
                    + 4 * -(-(2 * t.nb + 4) // digits) * 2**digits)
    smallest = ib.pack_bytes(t, 1, windowed=True)
    assert smallest == ib.pack_bytes(t, 1) + 4 * 8 * (len(counts) + 1) \
        + 4 * kernels.KEY_COUNT_BINS + 4
    rcfg, jrcfg = _rcfgs(len(deg), int(deg.sum()))
    want = jax_index.pack_index(ends, counts, deg, jrcfg)

    def free(b):
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda dev=None: (b, 1 << 40))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: 0)

    def launched(*a, **kw):
        raise AssertionError("K7 launched")
    monkeypatch.setattr(kernels, "pack_keys", launched)
    monkeypatch.setattr(kernels, "pack_key_counts", launched)
    # the windows' K7 here the plain chain, on the CPU
    monkeypatch.setattr(ib, "_card_windows",
                        lambda e, tt, free_endpoints: ib._plain_windows(e, tt))

    def pack(b):
        free(b)
        log = {}
        got = ib._pack_card(torch.from_numpy(ends), t, rcfg,
                            ib._splitter(log, "cpu"), True, log)
        return got, log["windows"]
    assert ib.window_cap(t, need) is None
    got, windows = pack(need - 1)
    assert windows == 2
    assert_same(got, want)
    cap = ib.window_cap(t, need - 1)
    assert ib.pack_bytes(t, cap, windowed=True) <= need - 1 < \
        ib.pack_bytes(t, cap + 1, windowed=True)
    assert ib.window_cap(t, smallest) == 1
    monkeypatch.setattr(ib, "_card_windows", launched)
    with pytest.raises(torch.OutOfMemoryError,
                       match=f"needs {smallest} bytes for its smallest"):
        pack(smallest - 1)


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


def _unpacked_index(ends, counts, deg, rcfg):
    """The plain pack's index without its row pointers."""
    return ib.pack_index_plain(torch.from_numpy(ends), counts, deg,
                               rcfg)._replace(dst_indptr=None)


def _assert_pointers(ptr, index):
    """``ptr`` [8, n + 1] (tensor or array) equals ``with_indptr``'s row
    pointers of ``index`` bucket for bucket; an empty bucket's row is
    zeros where ``with_indptr`` gives None."""
    ptr = np.asarray(ptr)
    want = ib.with_indptr(index._replace(dst_indptr=None)).dst_indptr
    assert ptr.shape == (ib.NUM_BUCKETS, index.n + 1)
    for q, w in enumerate(want):
        if w is None:
            assert not ptr[q].any(), q
        else:
            np.testing.assert_array_equal(ptr[q], w, err_msg=str(q))


@pytest.mark.parametrize("name", NAMES)
def test_plain_merge_pointers_equal_with_indptr(name):
    """K7-merge's plain version counts each bucket's row pointers equal to
    ``with_indptr``'s on every case: an empty bucket's zeros (one walk a
    node leaves buckets 0-6 empty, gap_buckets 1-6 between full ones),
    every node dangling (no walk, the self-edges only) and one node."""
    ends, counts, deg = case(name)
    rcfg, _ = _rcfgs(len(deg), max(int(deg.sum()), 1))
    t = ib.pack_tables(counts, deg)
    keys = ib.sort_keys_plain(ib.pack_keys_plain(
        torch.from_numpy(ends), *ib._device_tables(t, "cpu"), t.nb))
    src, dst, mult, bc, ptr = ib.merge_keys_plain(keys, t.nb, len(counts))
    index = _unpacked_index(ends, counts, deg, rcfg)
    np.testing.assert_array_equal(dst.numpy(), index.edge_dst)
    _assert_pointers(ptr.numpy(), index)
    if name in ("single_walk", "gap_buckets", "all_dangling"):
        assert (bc == 0).any()
    empty = ib.merge_keys_plain(keys[:0], t.nb, len(counts))
    assert not empty[4].any() and empty[4].shape == ptr.shape


@pytest.mark.parametrize("name", NAMES)
def test_pack_index_pointers_equal_with_indptr(name, monkeypatch):
    """``pack_index`` on the CPU takes the pointers from the packed tuple
    (``with_indptr`` is not called): they equal ``with_indptr``'s of the
    same index, None for an empty bucket."""
    ends, counts, deg = case(name)
    rcfg, _ = _rcfgs(len(deg), max(int(deg.sum()), 1))
    real = ib.with_indptr

    def called(*a, **kw):
        raise AssertionError("with_indptr ran on the packed branch")
    monkeypatch.setattr(ib, "with_indptr", called)
    idx = ib.pack_index(ends, counts, deg, rcfg)
    monkeypatch.setattr(ib, "with_indptr", real)
    want = ib.with_indptr(idx._replace(dst_indptr=None)).dst_indptr
    for got, w in zip(idx.dst_indptr, want):
        assert (got is None) == (w is None)
        if w is not None:
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("digit_bits", [8, 9, 11])
def test_pack_scratch_words(digit_bits):
    """K7-sort's scratch: ceil(64 / bits) rows of 2^bits digit totals, a
    ticket of 2 words and a status word a (4096-key tile, digit); K7-
    merge's: a 64-bit ticket, status word a tile and 9 offsets, then a
    word a 4096-place tile of each bucket's pointers; the sort refuses
    2^30 keys (its 30-bit counts), and so does ``pack_bytes`` before any
    launch."""
    R = 1 << digit_bits
    for L in (0, 1, 4095, 4096, 4097, 24_494_570, 2**30 - 1):
        T = -(-L // 4096)
        assert kernels.sort_scratch_words(L, digit_bits) == \
            -(-64 // digit_bits) * R + 2 + R * T
        for n in (1, 4095, 4096, 2**19):
            assert kernels.merge_scratch_words(L, n) == \
                2 * (1 + T + 9) + 8 * -(-(n + 1) // 4096)
    with pytest.raises(ValueError, match="30-bit"):
        kernels.sort_scratch_words(2**30, digit_bits)
    with pytest.raises(ValueError, match="8, 9 or 11"):
        kernels.sort_scratch_words(10, 10)
    t = ib.pack_tables(*case("no_dangling")[1:])
    big = t._replace(total=2**30 - len(t.dang))
    assert big.keys == 2**30
    with pytest.raises(ValueError, match="30-bit"):
        ib.pack_bytes(big)
    assert [kernels.sort_digit_bits(b) for b in (6, 28, 36, 42, 44, 46)] \
        == [8, 8, 9, 9, 9, 8]
    fits = t._replace(total=2**30 - 1 - len(t.dang))
    assert ib.pack_bytes(fits) > 28 * (2**30 - 1)


# ---- pack.cu's K7-sort and K7-merge, lane by lane ---------------------------
# Each warp of the kernels takes CHUNKS chunks of 32 neighbouring keys and a
# tile is WARPS warps (8 x 16 on the card); the emulations take smaller
# tiles too, so that small inputs cross many tiles.

def _place(k, nb, n1):
    return (k >> (2 * nb)) * n1 + ((k >> nb) & ((1 << nb) - 1))


def _run_end(keys, L, frm, tail):
    """pack.cu's run_end: a gallop of 32 probes, then 32-way searches."""
    lanes = np.arange(32)
    probe = frm - 1 + (1 << lanes)
    g = (probe >= L) | (keys[np.minimum(probe, L - 1)] != tail)
    lbit = int(np.argmax(g))
    lo = frm if lbit == 0 else frm + (1 << (lbit - 1))
    hi = min(L, frm - 1 + (1 << lbit))
    while lo < hi:
        step = (hi - lo + 31) // 32
        q = lo + lanes * step
        b = (q < hi) & (keys[np.minimum(q, L - 1)] != tail)
        if b.any():
            f = int(np.argmax(b))
            lo, hi = (lo + (f - 1) * step + 1 if f else lo), lo + f * step
        else:
            lo += min(31, (hi - 1 - lo) // step) * step + 1
    return lo


PLACE_TILE = 4096     # places a block of merge_pointers_kernel takes


def _pointers_pass(ptr, first_of_tile, offs, n1):
    """pack.cu's merge_pointers_kernel: each place the rank at the first
    place at or after it that holds one (past its tile, the first later
    tile's first, or U), less its row's offset."""
    tiles = first_of_tile.ravel()
    out = np.empty_like(ptr)
    for q in range(8):
        for k in range(first_of_tile.shape[1]):
            lin = q * first_of_tile.shape[1] + k
            later = tiles[lin + 1:]
            carry = later[later >= 0][0] if (later >= 0).any() else offs[8]
            lo, hi = k * PLACE_TILE, min(n1, (k + 1) * PLACE_TILE)
            nxt = carry
            for v in range(hi - 1, lo - 1, -1):
                if ptr[q, v] >= 0:
                    nxt = ptr[q, v]
                out[q, v] = nxt - offs[q]
    return out


def emulate_merge(keys, nb, n, warps=8, chunks=16):
    """merge_kernel and merge_pointers_kernel, a warp's chunk at a time; the
    look-back's result, the heads before each tile, as a running sum."""
    keys = np.asarray(keys, dtype=np.int64)
    L, n1, mask = len(keys), n + 1, (1 << nb) - 1
    tile = warps * chunks * 32
    T = -(-L // tile)
    src = np.full(L, -1, np.int64)
    dst = np.full(L, -1, np.int64)
    mult = np.full(L, -1.0)
    ptr = np.full(8 * n1, -1, np.int64)
    first_of_tile = np.full((8, -(-n1 // PLACE_TILE)), -1, np.int64)
    offs = np.full(9, -1, np.int64)
    lanes = np.arange(32)
    is_head = np.ones(L, bool)
    is_head[1:] = keys[1:] != keys[:-1]
    excl = 0
    for t in range(T):
        wheads = [int(is_head[t * tile + w * chunks * 32:
                              min(L, t * tile + (w + 1) * chunks * 32)].sum())
                  if t * tile + w * chunks * 32 < L else 0
                  for w in range(warps)]
        firsts, lasts, last_us = [], [], []
        for w in range(warps):
            wlo = t * tile + w * chunks * 32
            before = keys[wlo - 1] if 0 < wlo < L else 0
            u0 = excl + sum(wheads[:w])
            first = last = -1
            last_u = 0
            prev = before
            for it in range(chunks):
                c0 = wlo + it * 32
                if c0 >= L:
                    break
                i = c0 + lanes
                valid = i < L
                key = np.where(valid, keys[np.minimum(i, L - 1)], 0)
                left = np.concatenate([[prev], key[:31]])
                h = valid & ((i == 0) | (key != left))
                u = u0 + np.cumsum(h) - h
                u_end = u0 + int(h.sum())
                hl = np.nonzero(h)[0]
                for a, lane in enumerate(hl):
                    src[u[lane]] = key[lane] & mask
                    dst[u[lane]] = (key[lane] >> nb) & mask
                    if a + 1 < len(hl):
                        mult[u[lane]] = hl[a + 1] - lane
                    bq = key[lane] >> (2 * nb)
                    q0 = 0 if i[lane] == 0 else (left[lane] >> (2 * nb)) + 1
                    for q in range(q0, bq + 1):
                        assert offs[q] == -1
                        offs[q] = u[lane]
                if L - 1 in i:
                    for q in range((keys[L - 1] >> (2 * nb)) + 1, 9):
                        offs[q] = u_end
                if len(hl):
                    f = c0 + hl[0]
                    if last >= 0:
                        mult[last_u] = f - last
                    if first < 0:
                        first = f
                    last, last_u = c0 + hl[-1], u_end - 1
                pl = _place(key, nb, n1)
                pleft = _place(left, nb, n1)
                ptile = (key >> (2 * nb)) * first_of_tile.shape[1] + (
                    ((key >> nb) & mask) // PLACE_TILE)
                ptile_left = (left >> (2 * nb)) * first_of_tile.shape[1] + (
                    ((left >> nb) & mask) // PLACE_TILE)
                for lane in np.nonzero(valid & ((i == 0) | (pl != pleft)))[0]:
                    assert ptr[pl[lane]] == -1
                    ptr[pl[lane]] = u[lane]
                    if i[lane] == 0 or ptile[lane] != ptile_left[lane]:
                        assert first_of_tile.flat[ptile[lane]] == -1
                        first_of_tile.flat[ptile[lane]] = u[lane]
                u0, prev = u_end, key[31]
            firsts.append(first)
            lasts.append(last)
            last_us.append(last_u)
        tile_hi = min(L, (t + 1) * tile)
        after = tile_hi
        if tile_hi < L and max(lasts) >= 0 and keys[tile_hi] == keys[tile_hi - 1]:
            after = _run_end(keys, L, tile_hi, keys[tile_hi - 1])
        for w in range(warps):
            if lasts[w] >= 0:
                nxt = after
                for w2 in range(warps - 1, w, -1):
                    if firsts[w2] >= 0:
                        nxt = firsts[w2]
                mult[last_us[w]] = nxt - lasts[w]
        excl += sum(wheads)
    U = int(offs[8]) if L else 0
    if L:
        ptr = _pointers_pass(ptr.reshape(8, n1), first_of_tile, offs, n1)
        bc = np.diff(offs)
    else:
        ptr, bc = np.zeros((8, n1), np.int64), np.zeros(8, np.int64)
    assert (ptr >= 0).all()
    return src[:U], dst[:U], mult[:U], bc, ptr


def emulate_sort(keys, key_bits, digit_bits, warps=8, chunks=16):
    """radix_histogram_kernel's counts (a run of equal digits among a
    warp's neighbouring lanes added once), then onesweep_kernel a pass:
    per tile the warps' ranks by digit, the warp-order and digit-order
    starts in the tile, the look-back's exclusive prefix as a running sum
    over tiles, each key to its digit's base + its place in the staged
    tile.  Returns the sorted keys and the passes run."""
    keys = np.asarray(keys, dtype=np.int64)
    L, R = len(keys), 1 << digit_bits
    tile = warps * chunks * 32
    passes = -(-key_bits // digit_bits)
    totals = np.zeros((passes, R), np.int64)
    for c0 in range(0, L, 32):
        k = keys[c0:c0 + 32]
        for p in range(passes):
            d = (k >> (p * digit_bits)) & (R - 1)
            head = np.ones(len(d), bool)
            head[1:] = d[1:] != d[:-1]
            hl = np.nonzero(head)[0]
            ends = np.append(hl[1:], len(d))
            np.add.at(totals[p], d[hl], ends - hl)
    for p in range(passes):
        np.testing.assert_array_equal(
            totals[p], np.bincount((keys >> (p * digit_bits)) & (R - 1),
                                   minlength=R))
    cur, done = keys.copy(), 0
    for p in range(passes):
        if (totals[p] == L).any():
            continue
        shift = p * digit_bits
        dbase = np.concatenate([[0], np.cumsum(totals[p])[:-1]])
        out = np.full(L, -1, np.int64)
        before = np.zeros(R, np.int64)        # the digits in earlier tiles
        for t in range(-(-L // tile)):
            wcnt = np.zeros((warps, R), np.int64)
            ranks = {}
            for w in range(warps):
                for it in range(chunks):
                    i0 = t * tile + w * chunks * 32 + it * 32
                    for lane in range(32):
                        i = i0 + lane
                        if i >= L:
                            continue
                        d = (cur[i] >> shift) & (R - 1)
                        ranks[i] = (w, d, wcnt[w, d])
                        wcnt[w, d] += 1
            cnt = wcnt.sum(0)
            tstart = np.concatenate([[0], np.cumsum(cnt)[:-1]])
            wstart = tstart + np.concatenate(
                [np.zeros((1, R), np.int64), np.cumsum(wcnt, 0)[:-1]])
            stage = {}
            for i, (w, d, r) in ranks.items():
                stage[wstart[w, d] + r] = cur[i]
            gbase = dbase + before - tstart
            for pos, k in stage.items():
                j = gbase[(k >> shift) & (R - 1)] + pos
                assert out[j] == -1
                out[j] = k
            before += cnt
        cur, done = out, done + 1
    return cur, done


def _keys_of(name):
    ends, counts, deg = case(name)
    t = ib.pack_tables(counts, deg)
    keys = ib.pack_keys_plain(torch.from_numpy(ends),
                              *ib._device_tables(t, "cpu"), t.nb)
    return keys, t


@pytest.mark.parametrize("name", ["long_runs", "gap_buckets", "one_node",
                                  "all_dangling", "constant_digit"])
@pytest.mark.parametrize("shape", [(8, 16), (2, 2)])
def test_merge_lanes_match_plain(name, shape):
    """K7-merge's algorithm, lane by lane, equals the plain merge on the
    sorted keys: unique edges, multiplicities (within a chunk, across
    chunks, warps and tiles; a run past its tile found by the gallop),
    bucket counts, and the pointers: each key whose place differs from
    the key before's writes its rank there once, then the second launch's
    backward scan fills every place."""
    keys, t = _keys_of(name)
    if name == "long_runs":
        keys = keys[::4]       # its 30,000-key run still crosses tiles
    ordered = ib.sort_keys_plain(keys)
    got = emulate_merge(ordered.numpy(), t.nb, len(t.counts), *shape)
    want = ib.merge_keys_plain(ordered, t.nb, len(t.counts))
    for a, b, what in zip(got, want, ("src", "dst", "mult", "bc", "ptr")):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=what)


def test_run_end_gallop():
    """pack.cu's run_end finds the first place past a run's start whose
    key differs, for runs of every length up to 2^16 and at the end."""
    rng = np.random.default_rng(5)
    runs = np.concatenate([[1, 2, 31, 32, 33, 1000, 65536], rng.integers(
        1, 5000, 40)])
    keys = np.repeat(np.arange(len(runs)), runs)
    L = len(keys)
    starts = np.concatenate([[0], np.cumsum(runs)[:-1]])
    for s, r in zip(starts, runs):
        for frm in {s + 1, s + r // 2, s + r - 1}:
            if s < frm < L and frm <= s + r - 1 or frm == s + r:
                if 0 < frm < L:
                    assert _run_end(keys, L, frm, keys[frm - 1]) == s + r
    assert _run_end(keys, L, L - 1, keys[L - 2]) in (L - 1, L)


@pytest.mark.parametrize("digit_bits", [8, 9, 11])
@pytest.mark.parametrize("shape", [(8, 16), (2, 1)])
def test_sort_lanes_match_plain(digit_bits, shape):
    """K7-sort's algorithm (onesweep: the counts' runs, the warps' ranks,
    the tiles' starts and look-back, the staged scatter), emulated, sorts
    as ``torch.sort`` does: the keys of the long-runs case and keys that
    differ only in their low digits (a stability fault shows as wrong
    order between them), a pass with a constant digit skipped."""
    keys, t = _keys_of("long_runs")
    keys = keys[:6000].numpy()
    rng = np.random.default_rng(digit_bits)
    low = (np.int64(5) << 40) | rng.integers(0, 1 << 12, 3000)
    for k in (keys, low):
        got, passes = emulate_sort(k, 2 * t.nb + 4 if k is keys else 43,
                                   digit_bits, *shape)
        np.testing.assert_array_equal(got, np.sort(k))
    assert passes < -(-43 // digit_bits)        # the constant digits skipped


# ---- pack.cu's K7-keys, lane by lane -----------------------------------------
# A block of THREADS threads takes tiles of 8 THREADS entries (each thread
# two runs of four), stages up to STEPS x THREADS offsets, and the blocks
# take contiguous ranges of the tiles (the entries', then the dangling
# keys'); the card's are 512, 9 and its resident blocks (2 an SM).

KEYS_THREADS, KEYS_STEPS, KEYS_GRID = 512, 9, 2 * 132
BIG = np.iinfo(np.int64).max


def _first_above(a, lo, hi, x):
    """pack.cu's first_above, each lane its own search: the first index in
    [lo, hi) of the ascending ``a`` whose value is above x, or hi."""
    lo, hi = lo.copy(), np.broadcast_to(hi, lo.shape).copy()
    while (m := lo < hi).any():
        mid = (lo + hi) >> 1
        above = np.zeros_like(m)
        above[m] = a[mid[m]] > x[m]
        hi = np.where(m & above, mid, hi)
        lo = np.where(m & ~above, mid + 1, lo)
    return lo


def _warp_first_above(a, lo, hi, x):
    """pack.cu's warp_first_above: the same by 32 probes a step."""
    lanes = np.arange(32)
    while lo < hi:
        step = (hi - lo + 31) // 32
        q = lo + lanes * step
        b = (q < hi) & (a[np.minimum(q, hi - 1)] > x)
        if b.any():
            f = int(np.argmax(b))
            lo, hi = (lo + (f - 1) * step + 1 if f else lo), lo + f * step
        else:
            lo += min(31, (hi - 1 - lo) // step) * step + 1
    return lo


def _count_rounds(keys, valid, digit_bits, p_lo, passes, runs, hist):
    """pack.cu's count_digits over warps at once: ``keys`` [warps, 32], the
    lanes below ``valid`` [warps] holding one; in a pass of ``runs`` each
    run of equal digits among neighbouring lanes adds its length once, at
    its first lane, in the others each lane adds one."""
    R, lanes = 1 << digit_bits, np.arange(32)
    live = lanes < valid[:, None]
    for p in range(p_lo, passes):
        d = (keys >> (p * digit_bits)) & (R - 1)
        if not runs >> p & 1:
            np.add.at(hist[p], d[live], 1)
            continue
        head = live & ((lanes == 0) | (d != np.roll(d, 1, axis=1)))
        first = np.minimum.accumulate(
            np.where(head, lanes, 32)[:, ::-1], axis=1)[:, ::-1]
        after = np.concatenate([first[:, 1:], np.full((len(d), 1), 32)],
                               axis=1)
        end = np.minimum(after, valid[:, None])
        np.add.at(hist[p], d[head], (end - lanes)[head])


def _entry_bucket(j, K):
    """pack.cu's entry_bucket: #{q in 1..7 : j 4^q < K} as min(7, s / 2),
    s the largest with j 2^s < K, from the bit lengths' difference."""
    j, K = np.broadcast_arrays(np.asarray(j, np.int64), np.asarray(K, np.int64))
    bl = lambda x: np.where(x > 0, np.floor(np.log2(np.maximum(x, 1))) + 1,
                            0).astype(np.int64)
    sh = bl(K) - bl(j)
    s = np.where((j << np.maximum(sh, 0)) < K, sh, sh - 1)
    return np.where(j == 0, ib.NUM_BUCKETS - 1,
                    np.minimum(ib.NUM_BUCKETS - 1, s >> 1))


def emulate_keys(ends, offsets, dang, nb, threads=KEYS_THREADS,
                 steps=KEYS_STEPS, grid=KEYS_GRID, digit_bits=None,
                 takes=()):
    """pack_keys_kernel, a block's tiles in order, a thread's entries in
    order: each block's first tile finds its node by the warp's search,
    every tile stages the offsets from there until one is past its last
    entry (or searches the offsets in device memory where STEPS steps do
    not reach), each thread's first entry searched and its others moved on
    from it, the bucket by j 4^q < K; then the dangling tiles; with
    ``digit_bits`` the passes of source digits alone counted a node at a
    time by its entries in the tile, the others by each (run, entry) round
    of each warp, in runs where fewer than 4 of a pass's bits are endpoint
    bits.  Returns (keys, totals [passes, 2^digit_bits] or None, tiles
    whose stage fell short).  ``takes``: the count and window forms
    (``_CountForm``, ``_WindowForm``), each handed every run's keys of the
    block's threads as the kernel's take_keys gets them."""
    ends = np.asarray(ends, np.int64)
    total, n, nd = len(ends), len(offsets) - 1, len(dang)
    tile, run, warps = 8 * threads, 4 * threads, threads // 32
    Te = -(-total // tile)
    W = Te + -(-nd // tile)
    G = min(grid, W)
    keys = np.full(total + nd, -1, np.int64)
    passes = -(-(2 * nb + 4) // digit_bits) if digit_bits else 0
    totals = np.zeros((passes, 1 << (digit_bits or 0)), np.int64)
    sources = nb // digit_bits if digit_bits else 0
    runs = sum(1 << p for p in range(passes)
               if min((p + 1) * digit_bits, 2 * nb)
               - max(p * digit_bits, nb) < 4)
    lane_i = np.arange(threads)
    short = 0
    for b in range(G):
        t_lo, t_hi = b * W // G, (b + 1) * W // G
        v_base = -1
        for t in range(t_lo, min(t_hi, Te)):
            tlo = t * tile
            last = min(total, tlo + tile) - 1
            if v_base < 0:
                v_base = _warp_first_above(offsets, 0, n + 1, tlo) - 1
            stage, staged = np.empty(steps * threads, np.int64), 0
            for c in range(steps):
                idx = v_base + c * threads + lane_i
                val = np.where(idx <= n, offsets[np.minimum(idx, n)], BIG)
                stage[c * threads:(c + 1) * threads] = val
                if (val > last).any():
                    staged = (c + 1) * threads
                    break
            short += not staged
            a, a_hi = ((stage, staged) if staged
                       else (offsets[v_base:], n + 1 - v_base))
            if sources:
                k = np.arange(1, a_hi)
                lo = a[k - 1]
                k = k[lo <= last]
                c = np.minimum(a[k], last + 1) - np.maximum(a[k - 1], tlo)
                v = (v_base + k - 1)[c > 0]
                for p in range(sources):
                    np.add.at(totals[p], (v >> (p * digit_bits))
                              & ((1 << digit_bits) - 1), c[c > 0])
            for r in range(2):
                i = tlo + r * run + 4 * lane_i
                k = np.zeros(threads, np.int64)
                start = np.zeros(threads, np.int64)
                end = np.full(threads, np.iinfo(np.int64).min)
                key = np.zeros((threads, 4), np.int64)
                for u in range(4):
                    iu = i + u
                    valid = iu < total
                    move = valid & (iu >= end)
                    kk = np.minimum(_first_above(a, k + 1, a_hi, iu), a_hi - 1)
                    k = np.where(move, kk, k)
                    start = np.where(move, a[k - 1], start)
                    end = np.where(move, a[k], end)
                    bucket = _entry_bucket(np.where(valid, iu - start, 0),
                                           np.where(valid, end - start, 1))
                    ku = ((bucket << (2 * nb))
                          | (ends[np.minimum(iu, total - 1)] << nb)
                          | (v_base + k - 1))
                    keys[iu[valid]] = ku[valid]
                    key[:, u] = np.where(valid, ku, 0)
                for take in takes:
                    take(key, (i[:, None] + np.arange(4)) < total)
                for u in range(4) if digit_bits else ():
                    c0 = tlo + r * run + 4 * 32 * np.arange(warps) + u
                    _count_rounds(key[:, u].reshape(warps, 32),
                                  np.clip((total - c0 + 3) // 4, 0, 32),
                                  digit_bits, sources, passes, runs, totals)
            v_base += min(int(_first_above(a, np.array([1]), a_hi,
                                           np.array([last]))[0]),
                          a_hi - 1) - 1
        for t in range(max(t_lo, Te), t_hi):
            for s in range(8):
                c = (t - Te) * tile + s * threads   # warp w's keys c + 32 w ..
                d = c + lane_i
                valid = d < nd
                dv = dang[np.minimum(d, nd - 1)]
                key = np.where(valid, ((ib.NUM_BUCKETS - 1) << (2 * nb))
                               | (dv << nb) | dv, 0)
                keys[total + d[valid]] = key[valid]
                for take in takes:
                    take(key[:, None], valid[:, None])
                if digit_bits:
                    _count_rounds(key.reshape(warps, 32),
                                  np.clip(nd - (c + 32 * np.arange(warps)),
                                          0, 32), digit_bits, 0, passes, runs,
                                  totals)
    return keys, (totals if digit_bits else None), short


class _CountForm:
    """K7-keys' count form as its take_keys runs: each key of a run in [lo,
    hi) added to bin (k - lo) >> shift."""

    def __init__(self, lo, hi, shift):
        self.lo, self.hi, self.shift = lo, hi, shift
        self.bins = np.zeros(-(-(hi - lo) >> shift), np.int64)

    def __call__(self, key, live):
        k = key[live & (key >= self.lo) & (key < self.hi)]
        np.add.at(self.bins, (k - self.lo) >> self.shift, 1)


class _WindowForm:
    """K7-keys' window form as its take_keys runs: a run's keys in [lo, hi)
    at the places the block reserves (each thread's from its exclusive
    prefix over the block's threads on, one add on the cursor a block;
    blocks here in order, on the card in any), each pass's digit counted a
    key at a time."""

    def __init__(self, lo, hi, nb, digit_bits, capacity):
        self.lo, self.hi, self.digit_bits = lo, hi, digit_bits
        self.keys = np.full(capacity, -1, np.int64)
        self.cursor = 0
        self.totals = np.zeros((-(-(2 * nb + 4) // digit_bits),
                                1 << digit_bits), np.int64)

    def __call__(self, key, live):
        inr = live & (key >= self.lo) & (key < self.hi)
        c = inr.sum(axis=1)
        places = self.cursor + (np.cumsum(c) - c)[:, None] + (
            np.cumsum(inr, axis=1) - inr)
        assert (self.keys[places[inr]] == -1).all()
        self.keys[places[inr]] = key[inr]
        self.cursor += int(c.sum())
        R = 1 << self.digit_bits
        for p in range(len(self.totals)):
            np.add.at(self.totals[p], (key[inr] >> (p * self.digit_bits))
                      & (R - 1), 1)


@pytest.mark.parametrize("name", NAMES)
def test_keys_tiles_match_plain(name):
    """K7-keys' tile decomposition at the card's shape (512 threads, 4096-
    entry tiles, 264 blocks, the digit counts at the sort's width) on
    every case, and at small tiles (32 threads, 256-entry tiles, a stage of
    64 offsets, 3 blocks of long tile ranges, 8-bit digits) where it runs
    in time: the keys equal ``pack_keys_plain``'s (which reads the host's
    cutoff table), the counts ``np.bincount`` of each pass's digit.  The
    hub's node spans more than three tiles at the card's shape; the empty
    run's tiles search the offsets in device memory at both."""
    ends, counts, deg = case(name)
    t = ib.pack_tables(counts, deg)
    want = ib.pack_keys_plain(torch.from_numpy(ends),
                              *ib._device_tables(t, "cpu"), t.nb).numpy()
    offsets, dang = (a.numpy() for a in ib._card_tables(t, "cpu"))
    digits = kernels.sort_digit_bits(2 * t.nb + 4)
    shapes = [(KEYS_THREADS, KEYS_STEPS, KEYS_GRID, digits)]
    if t.keys < 200_000:
        shapes.append((32, 2, 3, 8))
    for threads, steps, grid, d in shapes:
        got, totals, short = emulate_keys(ends, offsets, dang, t.nb, threads,
                                          steps, grid, d)
        np.testing.assert_array_equal(got, want, err_msg=str(threads))
        for p in range(len(totals)):
            np.testing.assert_array_equal(
                totals[p], np.bincount((want >> (p * d)) & ((1 << d) - 1),
                                       minlength=1 << d), err_msg=str(p))
        assert (short > 0) >= (name == "empty_run"), threads
    if name == "hub_tiles":
        assert counts.max() > 3 * 8 * KEYS_THREADS


@pytest.mark.parametrize("name", NAMES)
def test_keys_forms_tiles_match_plain(name):
    """K7-keys' count and window forms, emulated lane by lane in the same
    tile walk at the card's shape and at small tiles: the count form over
    the whole key space by its top bits, and over one of those bins by the
    next bits, equal to ``np.bincount`` of the plain keys; the window form
    over three windows of the key space, each window's keys as a multiset
    equal to the plain keys filtered to it, its cursor their number, its
    digit counts each pass's bincount over them."""
    ends, counts, deg = case(name)
    t = ib.pack_tables(counts, deg)
    plain = ib.pack_keys_plain(torch.from_numpy(ends),
                               *ib._device_tables(t, "cpu"), t.nb).numpy()
    offsets, dang = (a.numpy() for a in ib._card_tables(t, "cpu"))
    bits = 2 * t.nb + 4
    top = max(bits - 14, 0)
    heavy = int(np.argmax(np.bincount(plain >> top))) << top if t.keys else 0
    spans = [(0, 1 << bits, top), (heavy, heavy + (1 << top), max(top - 14, 0))]
    cut = np.sort(plain)[[t.keys // 3, 2 * t.keys // 3]] if t.keys else [1, 2]
    edges = [0, int(cut[0]), max(int(cut[1]), int(cut[0]) + 1), 1 << bits]
    d = kernels.sort_digit_bits(bits)
    shapes = [(KEYS_THREADS, KEYS_STEPS, KEYS_GRID)]
    if t.keys < 200_000:
        shapes.append((32, 2, 3))
    for shape in shapes:
        cf = [_CountForm(*sp) for sp in spans]
        wf = [_WindowForm(lo, hi, t.nb, d, t.keys)
              for lo, hi in zip(edges, edges[1:])]
        emulate_keys(ends, offsets, dang, t.nb, *shape, takes=cf + wf)
        for f in cf:
            sel = plain[(plain >= f.lo) & (plain < f.hi)]
            np.testing.assert_array_equal(
                f.bins, np.bincount((sel - f.lo) >> f.shift,
                                    minlength=len(f.bins)), err_msg=str(shape))
            np.testing.assert_array_equal(
                f.bins, ib.pack_key_counts_plain(
                    torch.from_numpy(plain), f.lo, f.hi, f.shift).numpy())
        assert sum(f.cursor for f in wf) == t.keys
        for f in wf:
            want = ib.pack_keys_window_plain(torch.from_numpy(plain), f.lo,
                                             f.hi).numpy()
            assert f.cursor == len(want)
            np.testing.assert_array_equal(np.sort(f.keys[:f.cursor]),
                                          np.sort(want), err_msg=str(shape))
            for p in range(len(f.totals)):
                np.testing.assert_array_equal(
                    f.totals[p], np.bincount((want >> (p * d)) & ((1 << d) - 1),
                                             minlength=1 << d))


def _windows_case():
    """1024 nodes of 8-40 walks, half of them ending at node 7, and 50
    dangling nodes: 10-bit ids, so a bin of the count form's top 14 key
    bits is one (bucket, endpoint), and endpoint 7's bins hold thousands of
    keys of a few each (one per source and walk there)."""
    rng = np.random.default_rng(26)
    n = 1024
    deg = rng.integers(1, 9, n)
    deg[rng.choice(n, 50, replace=False)] = 0
    counts = np.where(deg > 0, rng.integers(8, 41, n), 0)
    ends = rng.integers(0, n, int(counts.sum()))
    ends[rng.random(len(ends)) < 0.5] = 7
    return ends.astype(np.int32), counts, deg


@pytest.mark.parametrize("name", NAMES + ("windows",))
@pytest.mark.parametrize("windows", ["one", "two", "many"])
def test_windowed_pack_matches_plain_and_jax(name, windows):
    """``_pack_windows`` over the plain chain (``_pack_planned`` over
    ``_plain_windows``), with the cap forcing one, two and many windows:
    arrays and row pointers equal to the pack in one sort (``_pack_plain``)
    and to JAX's pack, on every pack case and on one whose hot endpoint's
    bins pass the cap (split by a count over their next bits); the edge
    arrays, made for every key, shrunk to the unique edges and owning
    their memory."""
    ends, counts, deg = _windows_case() if name == "windows" else case(name)
    rcfg, jrcfg = _rcfgs(len(deg), max(int(deg.sum()), 1))
    t = ib.pack_tables(counts, deg)
    keys = ib.pack_keys_plain(torch.from_numpy(ends),
                              *ib._device_tables(t, "cpu"), t.nb)
    run = int(torch.unique(keys, return_counts=True)[1].max()) if t.keys \
        else 0
    cap = {"one": t.keys, "two": t.keys - 1,
           "many": max(run, t.keys // 8)}[windows]
    if cap < max(run, 1) or (windows == "many" and cap >= t.keys - 1):
        pytest.skip(f"{name}: {t.keys} keys, runs of {run}: no such windows")
    one = ib.pack_index_plain(torch.from_numpy(ends), counts, deg, rcfg)
    log = {}
    got = ib._pack_planned(t, rcfg, ib._splitter(log, "cpu"), cap,
                           ib._plain_windows(torch.from_numpy(ends), t),
                           "cpu", log)
    assert log["windows"] == 1 if windows == "one" else log["windows"] >= 2
    assert_same(got, one)
    assert_same(got, jax_index.pack_index(ends, counts, deg, jrcfg))
    for a in (got.edge_src, got.edge_dst, got.edge_mult):
        assert a.base is None and a.shape == (got.total_edges,)
    for a, b in zip(got.dst_indptr, one.dst_indptr):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_windows_split_a_bin_over_the_cap():
    """The plan over the windows case at a cap below its heaviest bin of the
    top 14 key bits: that bin is counted again over its next bits (a
    second count launch, restricted to it), and the pack equals JAX's."""
    ends, counts, deg = _windows_case()
    rcfg, jrcfg = _rcfgs(len(deg), int(deg.sum()))
    t = ib.pack_tables(counts, deg)
    count, pack = ib._plain_windows(torch.from_numpy(ends), t)
    calls = []

    def counted(lo, hi, shift):
        calls.append((lo, hi, shift))
        return count(lo, hi, shift)
    top = count(0, 1 << (2 * t.nb + 4), 2 * t.nb + 4 - 14)
    cap = int(top.max()) // 3
    windows = ib.plan_windows(counted, t.nb, cap)
    assert len(calls) >= 2 and calls[1][2] == 0
    assert calls[1][1] - calls[1][0] == 1 << (2 * t.nb + 4 - 14)
    assert len(windows) > t.keys // cap
    got = ib._pack_windows(t, rcfg, windows, pack, ib._splitter(None, "cpu"),
                           "cpu")
    assert_same(got, jax_index.pack_index(ends, counts, deg, jrcfg))


@pytest.mark.parametrize("name", ["long_runs", "many_tiles", "windows"])
def test_plan_windows_cover_and_cap(name):
    """The planner's windows are contiguous, in key order, cover the key
    space [0, 2^(2 nb + 4)), each holds what its count says (the keys in
    it) and at most the cap; a key value held more times than the cap
    raises, naming its node."""
    ends, counts, deg = _windows_case() if name == "windows" else case(name)
    t = ib.pack_tables(counts, deg)
    keys = ib.pack_keys_plain(torch.from_numpy(ends),
                              *ib._device_tables(t, "cpu"), t.nb)
    count, _ = ib._plain_windows(torch.from_numpy(ends), t)
    u, c = torch.unique(keys, return_counts=True)
    run = int(c.max())
    ordered = np.sort(keys.numpy())
    # windows of the longest run only where there are few of them: each
    # bin over that cap is counted again
    for cap in (t.keys, max(run, t.keys // 5)) + (
            (run,) if t.keys < 100_000 else ()):
        windows = np.array(ib.plan_windows(count, t.nb, cap), np.int64)
        lo, hi, k = windows.T
        assert lo[0] == 0 and hi[-1] == 1 << (2 * t.nb + 4)
        np.testing.assert_array_equal(lo[1:], hi[:-1])
        assert (lo < hi).all() and (k > 0).all() and (k <= cap).all()
        np.testing.assert_array_equal(
            k, np.searchsorted(ordered, hi) - np.searchsorted(ordered, lo))
        assert k.sum() == t.keys
    heavy = int(u[c.argmax()])
    node = heavy & ((1 << t.nb) - 1)
    with pytest.raises(ValueError, match=f"node {node}'s pool holds "
                       f"endpoint {(heavy >> t.nb) & ((1 << t.nb) - 1)} "
                       f"{run} times"):
        ib.plan_windows(count, t.nb, run - 1)


def test_integer_cutoffs_equal_host_table():
    """The cutoffs K7-keys forms from K_v on the card, (K + 4^q - 1) >> 2q
    and its test j 4^q < K, equal the host's float64 ceil(K 4^-q) of
    ``pack_tables`` (which the plain version and ``counts_cum`` read):
    every K below 2^20, K at 4^q - 1, 4^q and 4^q + 1 up to q = 26, and
    random K up to 2^40; and the kernel's bucket from the bit lengths of j
    and K counts them, for every j < K below 3000 and at random j < K up
    to 2^31."""
    rng = np.random.default_rng(25)
    edges = np.array([4**q + o for q in range(27) for o in (-1, 0, 1)])
    for K in (np.arange(1 << 20), edges[edges >= 0],
              rng.integers(0, 1 << 40, 1 << 16)):
        cut = ib.pack_tables(K, np.ones_like(K)).cut
        for q in range(1, ib.NUM_BUCKETS):
            np.testing.assert_array_equal((K + 4**q - 1) >> (2 * q),
                                          cut[:, q], err_msg=str(q))
    K = np.arange(1, 3000)[:, None]
    j = np.arange(3000)[None, :]
    cut = ib.pack_tables(K[:, 0], np.ones(len(K))).cut
    for q in range(1, ib.NUM_BUCKETS):
        np.testing.assert_array_equal((j << (2 * q)) < K,
                                      j < cut[:, q:q + 1], err_msg=str(q))
    live = j < K
    np.testing.assert_array_equal(
        _entry_bucket(j, K)[live],
        sum((j < cut[:, q:q + 1]) for q in range(1, ib.NUM_BUCKETS))[live])
    K = rng.integers(1, 2**31 - 1, 1 << 16)
    j = (rng.random(len(K)) ** 4 * K).astype(np.int64)
    np.testing.assert_array_equal(
        _entry_bucket(j, K), sum(((j << (2 * q)) < K).astype(np.int64)
                                 for q in range(1, ib.NUM_BUCKETS)))
