"""The plain reference: exact PPR against analytic PPR on a cycle and a
star; the frozen copies of the query draw and precision@k against the
program's; the benchmark's own generator and CSR layout against the
program's host packing at a small size."""

import numpy as np
import pytest
import torch

import pprbench_cases  # noqa: F401  (puts the checkout on sys.path)
from pprbench import graphgen
from pprbench.reference import metrics, ppr, queries

ALPHA = 0.2


def test_cycle_is_analytic():
    n = 12
    src = torch.arange(n)
    dst = (src + 1) % n
    x = ppr.exact_ppr(ppr.transition(src, dst, n), [3], ALPHA, tol=1e-14)
    j = (np.arange(n) - 3) % n
    want = ALPHA * (1 - ALPHA) ** j / (1 - (1 - ALPHA) ** n)
    np.testing.assert_allclose(x[:, 0].numpy(), want, rtol=1e-12)


def test_star_is_analytic():
    n = 9
    src = torch.zeros(n - 1, dtype=torch.int64)
    dst = torch.arange(1, n)
    a = ppr.transition(src, dst, n)
    x = ppr.exact_ppr(a, [0, 4], ALPHA, tol=1e-15)
    want0 = np.full(n, (1 - ALPHA) / (n - 1))
    want0[0] = ALPHA          # the leaves keep the mass they get
    np.testing.assert_allclose(x[:, 0].numpy(), want0, rtol=1e-12)
    want4 = np.zeros(n)
    want4[4] = 1.0            # a dangling source keeps all of it
    np.testing.assert_allclose(x[:, 1].numpy(), want4, atol=1e-15)


def test_parallel_edges_count_twice():
    src = torch.tensor([0, 0, 0])
    dst = torch.tensor([1, 1, 2])
    x = ppr.exact_ppr(ppr.transition(src, dst, 3), [0], ALPHA, tol=1e-15)
    np.testing.assert_allclose(x[1:, 0].numpy(),
                               [(1 - ALPHA) * 2 / 3, (1 - ALPHA) / 3])


def test_topk_ties_go_to_the_lowest_id():
    x = torch.tensor([[0.1], [0.3], [0.1], [0.3], [0.0]], dtype=torch.float64)
    ids, vals = ppr.topk_exact(x, 3)
    assert ids.tolist() == [[1, 3, 0]]
    assert vals.tolist() == [[0.3, 0.3, 0.1]]


def test_reference_answers_match_the_program_oracle():
    from fora_tpu_torch.algo import exact
    from fora_tpu_torch.graph.csr import CSRGraph
    (src, dst), n = graphgen.make_graph(
        {"generator": "kronecker", "scale": 9, "edgefactor": 8, "a": 0.57,
         "b": 0.19, "c": 0.19}, "cpu", 3)
    g = CSRGraph(**graphgen.csr_fields(src, dst, n))
    sources = queries.generate_sources(g.out_deg, 5, seed=2)
    ids = np.tile(np.arange(10), (5, 1))
    top, top_vals, at = ppr.reference_answers(src, dst, n, sources, ids,
                                              ALPHA, 10, block=2, tol=1e-12)
    x = exact.exact_ppr_batch(g, sources, ALPHA, device="cpu")
    np.testing.assert_array_equal(top, exact.topk_ids(x, 10))
    np.testing.assert_allclose(
        top_vals, np.take_along_axis(x.T.numpy(), top, 1), rtol=1e-9,
        atol=1e-15)
    np.testing.assert_allclose(at, x.T[:, :10].numpy(), rtol=1e-9,
                               atol=1e-15)


def test_frozen_copies_equal_the_program():
    from fora_tpu_torch.eval import metrics as pm
    from fora_tpu_torch.eval import queries as pq
    from fora_tpu_torch.graph import generators
    g = generators.rmat(9, 4000, seed=5)
    for seed in (0, 7, 2**31 + 11):
        np.testing.assert_array_equal(
            queries.generate_sources(g.out_deg, 40, seed=seed),
            pq.generate_sources(g, 40, seed=seed))
    rng = np.random.default_rng(1)
    pred = rng.integers(0, 30, (6, 10))
    ex = rng.integers(0, 30, (6, 10))
    assert metrics.batch_precision_at_k(pred, ex) == \
        pm.batch_precision_at_k(pred, ex)
    assert metrics.precision_at_k(pred[0], ex[0]) == \
        pm.precision_at_k(pred[0], ex[0])


@pytest.mark.parametrize("scale,edgefactor,seed", [(8, 4, 1), (10, 16, 2**33 + 5)])
def test_csr_layout_equals_from_edges(scale, edgefactor, seed):
    from fora_tpu_torch.graph.csr import from_edges
    src, dst = graphgen.kronecker_edges(scale, edgefactor, 0.57, 0.19, 0.19,
                                        seed, "cpu")
    n = 1 << scale
    assert src.shape == (edgefactor * n,) and not bool((src == dst).any())
    assert int(src.min()) >= 0 and int(max(src.max(), dst.max())) < n
    got = graphgen.csr_fields(src, dst, n)
    want = from_edges(src.numpy(), dst.numpy(), n)
    for name, arr in got.items():
        np.testing.assert_array_equal(arr, getattr(want, name), err_msg=name)
        assert arr.dtype == getattr(want, name).dtype, name
    assert graphgen.unique_edges(src, dst, n) == \
        len(np.unique(src.numpy() * n + dst.numpy()))


def test_generator_follows_the_seed_and_the_law():
    a = graphgen.kronecker_edges(12, 16, 0.57, 0.19, 0.19, 9, "cpu")
    b = graphgen.kronecker_edges(12, 16, 0.57, 0.19, 0.19, 9, "cpu")
    c = graphgen.kronecker_edges(12, 16, 0.57, 0.19, 0.19, 10, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    # a power law: the busiest 1% of sources send far more than 1% of edges
    deg = torch.bincount(a[0], minlength=1 << 12).sort(descending=True).values
    assert int(deg[:41].sum()) > 0.1 * a[0].numel()


@pytest.mark.cuda
def test_generator_and_layout_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fora_tpu_torch.graph.csr import from_edges
    src, dst = graphgen.kronecker_edges(14, 16, 0.57, 0.19, 0.19, 4, "cuda")
    got = graphgen.csr_fields(src, dst, 1 << 14)
    want = from_edges(src.cpu().numpy(), dst.cpu().numpy(), 1 << 14)
    for name, arr in got.items():
        np.testing.assert_array_equal(arr, getattr(want, name), err_msg=name)
