"""The selection of the split accept (K3) as plain tensor code: the plan
the wrapper hands to ``csrc/topk_bounds.cu``, and a model of what the
kernels do with it, for the tests.

Per column b, with "before" = value descending then id ascending and
kk = k + 1:

1. ``sample_threshold``: tau_b, the kk-th largest score over every
   ``stride``-th row.  At least kk rows score >= tau_b.
2. ``keep_mask``: a row is a candidate when its score v > tau_b, or v ==
   tau_b and (tau_b != 0 or id < kk).  A zero at id >= kk has kk rows
   before it when no score is negative; a negative score beside tau_b == 0
   flags the column for the dense path instead.
3. the candidates' first kk by "before" (``block_select_sorted``, the
   pruned bitonic network one block runs in shared memory).
4. a column with more than ``capacity`` candidates (or fewer than kk, or
   flagged) takes the dense path: every slab of ``SEGMENT`` rows selected,
   then the slabs' candidates merged.

Only ``select_plan`` runs on the query path; the rest is used by tests.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SEGMENT = 4096        # keys one block selects from; SEG in topk_bounds.cu
SAMPLE_STRIDE = 32    # the sparsest sample: kk * stride candidates expected
DENSE_SEGMENTS = 4    # inputs of at most this many segments go dense
NO_ID = 0x7FFFFFFF


def select_plan(n: int, kk: int, capacity: int = SEGMENT) -> int:
    """The row stride of the threshold sample for an [n, B] input, or 0
    for the dense path.  The sample is as sparse as keeps the expected
    kk * stride candidates within half the list capacity, and holds at
    least kk rows."""
    stride = min(SAMPLE_STRIDE, capacity // (2 * kk))
    if stride < 2 or n <= DENSE_SEGMENTS * SEGMENT or -(-n // stride) < kk:
        return 0
    return stride


def sample_threshold(score: torch.Tensor, kk: int, stride: int
                     ) -> torch.Tensor:
    """tau [B]: the kk-th largest of score[::stride] per column (-inf where
    the sample holds fewer than kk rows)."""
    sample = score[::stride]
    if sample.shape[0] < kk:
        return torch.full((score.shape[1],), -torch.inf, dtype=score.dtype)
    return torch.sort(sample, dim=0, descending=True).values[kk - 1]


def keep_mask(score: torch.Tensor, tau: torch.Tensor, kk: int):
    """(keep [n, B] bool, flagged [B] bool) of the filter pass."""
    ids = torch.arange(score.shape[0])[:, None]
    tie = (score == tau) & ((tau != 0) | (ids < kk))
    flagged = ((score < 0) & (tau == 0)).any(dim=0)
    return (score > tau) | tie, flagged


def _before(va, ia, vb, ib):
    return (va > vb) | ((va == vb) & (ia < ib))


def _cmpx(v, i, lo, hi, desc):
    """Compare-exchange of the keys at positions lo < hi (index tensors);
    ``desc`` (bool tensor) puts the one that comes before at lo."""
    va, vb, ia, ib = v[lo], v[hi], i[lo], i[hi]
    swap = torch.where(desc, _before(vb, ib, va, ia), _before(va, ia, vb, ib))
    v[lo], v[hi] = torch.where(swap, vb, va), torch.where(swap, va, vb)
    i[lo], i[hi] = torch.where(swap, ib, ia), torch.where(swap, ia, ib)


def _chunk_pos(a, lk, r):
    return ((a >> lk) << (lk + r)) | (a & ((1 << lk) - 1))


def block_select_sorted(v: torch.Tensor, i: torch.Tensor, lk: int):
    """The network of ``block_select_sorted`` in topk_bounds.cu, stage by
    stage, on copies of the L keys (v, i): the first K2 = 1 << lk by
    "before", sorted.  L is a power of two, K2 <= L."""
    v, i = v.clone(), i.clone()
    L, K2 = v.shape[0], 1 << lk
    pos = torch.arange(L)
    k = 2
    while k <= K2:           # chunks of K2 sorted, alternating directions
        j = k >> 1
        while j > 0:
            lo = pos[(pos ^ j) > pos]
            _cmpx(v, i, lo, lo ^ j, (lo & k) == 0)
            j >>= 1
        k <<= 1
    A, r = L, 0
    while A > K2:            # pairs of chunks halved
        h = torch.arange(A >> 1)
        a = ((h >> lk) << (lk + 1)) | (h & (K2 - 1))
        _cmpx(v, i, _chunk_pos(a, lk, r), _chunk_pos(a + K2, lk, r),
              torch.ones_like(h, dtype=torch.bool))
        j = K2 >> 1
        while j > 0:
            lo = h[(h ^ j) > h]
            _cmpx(v, i, _chunk_pos(lo, lk, r + 1),
                  _chunk_pos(lo ^ j, lk, r + 1), ((lo >> lk) & 1) == 0)
            j >>= 1
        A >>= 1
        r += 1
    return v[:K2], i[:K2]


def _padded_select(v, i, kk):
    """First kk of the keys (v, i) through the block network."""
    lk = max(1, (kk - 1).bit_length())
    L = 1 << lk
    while L < v.shape[0]:
        L <<= 1
    pv = torch.full((L,), -torch.inf, dtype=v.dtype)
    pi = torch.full((L,), NO_ID, dtype=torch.int64)
    pv[:v.shape[0]], pi[:v.shape[0]] = v, i
    sv, si = block_select_sorted(pv, pi, lk)
    return sv[:kk], si[:kk]


def dense_column(score: torch.Tensor, kk: int):
    """The dense path on one column [n]: each slab of SEGMENT rows
    selected, the slabs' candidates merged SEGMENT at a time."""
    v, i = score, torch.arange(score.shape[0])
    while True:
        parts = [_padded_select(v[lo:lo + SEGMENT], i[lo:lo + SEGMENT], kk)
                 for lo in range(0, v.shape[0], SEGMENT)]
        v = torch.cat([a for a, _ in parts])
        i = torch.cat([b for _, b in parts])
        if len(parts) == 1:
            return v, i


class Selection(NamedTuple):
    vals: torch.Tensor      # [B, kk] the first kk scores per column
    idx: torch.Tensor       # [B, kk] int64 their rows
    counts: torch.Tensor    # [B] candidates the filter found (0 when dense
    #                         by shape)
    dense: torch.Tensor     # [B] bool: the column took the dense path


def select_topk(p: torch.Tensor, contrib: torch.Tensor, k: int,
                stride: int = None, capacity: int = SEGMENT,
                seed: int = 0) -> Selection:
    """Model of ``kernels.topk_bounds``'s selection on CPU tensors: the
    top-(k+1) of p + contrib per column by steps 1-4.  The candidates are
    appended in a random order (``seed``), as the card's atomics would."""
    n, B = p.shape
    kk = k + 1
    if stride is None:
        stride = select_plan(n, kk, capacity)
    score = p + contrib
    counts = torch.zeros(B, dtype=torch.int64)
    dense = torch.ones(B, dtype=torch.bool)
    if stride:
        keep, flagged = keep_mask(score, sample_threshold(score, kk, stride),
                                  kk)
        counts = keep.sum(dim=0)
        dense = (counts > capacity) | (counts < kk) | flagged
    gen = torch.Generator().manual_seed(seed)
    vals, idx = [], []
    for b in range(B):
        if dense[b]:
            v, i = dense_column(score[:, b], kk)
        else:
            rows = keep[:, b].nonzero()[:, 0]
            rows = rows[torch.randperm(rows.shape[0], generator=gen)]
            v, i = _padded_select(score[rows, b], rows, kk)
        vals.append(v)
        idx.append(i)
    return Selection(torch.stack(vals), torch.stack(idx), counts, dense)
