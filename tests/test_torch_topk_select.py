"""The selection of fora_tpu_torch's split accept (K3) as its plain model
(``kernels/select.py``: sample threshold, keep rule, capacity, overflow to
the dense path, the block's pruned bitonic network) against
``topk_rows_chunked`` and, through the accept's epilogue, against
fora_tpu's ``_topk_with_bounds_split`` on the CPU.

Ids are compared exactly (value descending, then id ascending); values
and bounds at rtol 1e-6, the lower bounds with atol 1e-10 beside it:
lb = mu - s2/3 - sqrt(s2 ub) cancels, so one ulp of XLA's sqrt shows as
about 3e-11 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from topk_cases import CASES, dense_columns

from fora_tpu.algo import bounds as jax_bounds
from fora_tpu_torch import kernels
from fora_tpu_torch.algo import bounds
from fora_tpu_torch.kernels import select
from fora_tpu_torch.ops.topk import topk_rows_chunked

torch.set_num_threads(2)


@pytest.mark.parametrize("name", list(CASES))
def test_selection_model_matches_plain_and_jax(name):
    make, k, stride, capacity, dense, jax_ok = CASES[name]
    p_np, c_np = make(np.random.default_rng(len(name)))
    p, contrib = torch.as_tensor(p_np), torch.as_tensor(c_np)
    n, B = p.shape
    sel = select.select_topk(p, contrib, k, stride=stride,
                             capacity=capacity or select.SEGMENT, seed=1)
    np.testing.assert_array_equal(sel.dense.numpy(), dense_columns(dense, B))
    want_v, want_i, want_p = topk_rows_chunked(p, k + 1, p, addend=contrib)
    assert torch.equal(sel.idx, want_i)
    assert torch.equal(sel.vals, want_v)
    # another append order, the same answer
    again = select.select_topk(p, contrib, k, stride=stride,
                               capacity=capacity or select.SEGMENT, seed=2)
    assert torch.equal(again.idx, sel.idx) and torch.equal(again.vals,
                                                           sel.vals)
    if not jax_ok:
        return
    omega, eps = 3.4e5, 0.5
    t = jax_bounds.union_bound_t(n, 3, 1.0 / n)
    p_at = torch.gather(p.T, 1, sel.idx)
    got = [a.numpy() for a in bounds._bounds(sel.vals, sel.idx, p_at, omega,
                                             k, t, eps)]
    want = [np.asarray(a) for a in jax_bounds._topk_with_bounds_split(
        jnp.asarray(p_np), jnp.asarray(c_np), jnp.float32(omega), k=k, t=t,
        eps=eps)]
    np.testing.assert_array_equal(got[1], want[1])               # ids
    for i in (0, 3, 5):                        # vals, ub, ub_excluded
        np.testing.assert_allclose(got[i], want[i], rtol=1e-6, atol=0)
    for i in (2, 4):                           # lb, lbk
        np.testing.assert_allclose(got[i], want[i], rtol=1e-6, atol=1e-10)
    edge = np.abs(want[4] * (1 + eps) - want[5]) <= 1e-6 * np.abs(want[5])
    np.testing.assert_array_equal(got[6][~edge], want[6][~edge])


@pytest.mark.parametrize("L,kk", [(2, 2), (64, 3), (64, 51), (256, 11),
                                  (4096, 51), (4096, 65), (4096, 4096),
                                  (1024, 200)])
def test_block_network_selects_the_first_keys(L, kk):
    """The pruned bitonic network leaves the first 2^ceil(log2 kk) keys, by
    (value descending, id ascending), sorted in front, with heavy ties."""
    rng = np.random.default_rng(L + kk)
    lk = max(1, (kk - 1).bit_length())
    v = np.floor(rng.random(L) * 6).astype(np.float32)
    v[rng.random(L) < 0.2] = -np.inf
    ids = rng.permutation(3 * L)[:L]
    sv, si = select.block_select_sorted(torch.as_tensor(v),
                                        torch.as_tensor(ids), lk)
    order = np.lexsort((ids, -v.astype(np.float64)))[:1 << lk]
    np.testing.assert_array_equal(si.numpy(), ids[order])
    np.testing.assert_array_equal(sv.numpy(), v[order])


@pytest.mark.parametrize("n,kk,capacity,want", [
    (1 << 19, 51, 4096, 32),        # the bench graph: every 32nd row
    (131072, 51, 4096, 32),         # one shard of four
    (4 * 4096, 51, 4096, 0),        # a few segments: dense by shape
    (40_000, 101, 4096, 20),        # a larger k: a denser sample
    (40_000, 1500, 4096, 0),        # 2 kk candidates would not fit: dense
    (40_000, 51, 64, 0),            # so small a capacity: dense
    (1 << 19, 4096, 4096, 0),
])
def test_select_plan(n, kk, capacity, want):
    assert select.select_plan(n, kk, capacity) == want


def test_threshold_keeps_every_winner():
    """At least kk rows score >= tau, and the keep rule drops no member of
    the true top-kk, whatever the sample misses."""
    rng = np.random.default_rng(5)
    n, B, kk = 30_000, 6, 51
    score = torch.as_tensor((rng.random((n, B)) ** 6).astype(np.float32))
    score[:, 0] = 0.0
    score[100:110, 0] = 1.0                 # fewer than kk positive rows
    tau = select.sample_threshold(score, kk, 32)
    keep, flagged = select.keep_mask(score, tau, kk)
    assert not flagged.any()
    assert bool(((score >= tau).sum(dim=0) >= kk).all())
    top = topk_rows_chunked(score, kk)[1]
    assert bool(torch.gather(keep.T, 1, top).all())
    # the ten positive rows, and the zeros of ids 0..kk-1
    assert float(tau[0]) == 0.0 and int(keep[:, 0].sum()) == kk + 10


def test_wrapper_takes_cuda_tensors_only(monkeypatch):
    # as in a fresh process, whatever ran K3 earlier in this one
    monkeypatch.setattr(kernels.topk_bounds, "last_state", None)
    p = torch.zeros((100, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.topk_bounds(p, p, 5, 0.0, 1.0)
    with pytest.raises(RuntimeError, match="has not run"):
        kernels.topk_bounds_stats()


def test_sector_probe_takes_cuda_tensors_only():
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.sector_reads(torch.zeros(1024, dtype=torch.int32))
    assert kernels.launch_counts() == before
