"""P3 (``row_scatter_add``): its plain version against the Pallas kernel of
``scripts/pallas_gather_probe.py`` run in interpret mode with the script's
own BlockSpecs, and against K1's plain path on the same edges sorted by
destination; and the probe's cases on the CPU.

The Pallas kernel and ``index_add_`` on the CPU both add the edges in
order, so they agree to rtol 1e-6; K1 sums each row in its own order
(rtol 1e-5).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fora_tpu_torch.ops.gather import (gather_scatter_add_plain,
                                       row_scatter_add, row_scatter_add_plain)
from fora_tpu_torch.probes import gather_probe

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _pallas_probe():
    spec = importlib.util.spec_from_file_location(
        "pallas_gather_probe", ROOT / "scripts" / "pallas_gather_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_accumulate(mod, src, dst, tile):
    """The script's pallas_call (its kernel and BlockSpecs) in interpret
    mode over len(src) edges."""
    B = tile.shape[1]
    call = pl.pallas_call(
        mod.kernel,
        grid=(src.shape[0] // mod.CHUNK,),
        in_specs=[
            pl.BlockSpec((mod.CHUNK,), lambda i: (i,),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((mod.CHUNK,), lambda i: (i,),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((mod.H, B), lambda i: (0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((mod.N_DST, B), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((mod.N_DST, B), jnp.float32),
        interpret=True)
    return np.asarray(call(jnp.asarray(src), jnp.asarray(dst),
                           jnp.asarray(tile)))


def test_plain_matches_pallas_kernel():
    mod = _pallas_probe()
    assert (mod.H, mod.N_DST) == (gather_probe.H, gather_probe.N_DST)
    src, dst, tile = gather_probe.probe_edges(mod.B, "cpu",
                                              e_total=2 * mod.CHUNK)
    want = _pallas_accumulate(mod, src.numpy(), dst.numpy(), tile.numpy())
    got = row_scatter_add_plain(torch.zeros((mod.N_DST, mod.B)), tile, src,
                                dst)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # the dispatching wrapper takes the plain version for CPU tensors
    again = row_scatter_add(torch.zeros_like(got), tile, src, dst)
    assert torch.equal(again, got)


@pytest.mark.parametrize("B", gather_probe.WIDTHS)
def test_plain_matches_k1_on_sorted_edges(B):
    src, dst, tile = gather_probe.probe_edges(B, "cpu", e_total=1 << 14)
    got = row_scatter_add_plain(torch.zeros((gather_probe.N_DST, B)), tile,
                                src, dst)
    indptr, src_d = gather_probe.by_destination(src, dst, gather_probe.N_DST)
    assert indptr[-1] == src.shape[0]
    assert (torch.diff(indptr.long()) == torch.bincount(
        dst.long(), minlength=gather_probe.N_DST)).all()
    want = gather_scatter_add_plain(torch.zeros_like(got), tile, indptr,
                                    src_d)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_probe_cases_on_cpu():
    """The probe's case functions on the plain versions, with a host
    timer: errors within the probe's tolerance, one rate line each."""
    import time

    def host_ms(fn):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    res = gather_probe.p3_case(32, "cpu", host_ms, e_total=4096)
    assert res["err_plain"] == 0.0 and res["err_k1"] <= 1e-5
    assert len(res["lines"]) == 3 and "M edges/s" in res["lines"][0]
    from fora_tpu_torch.graph import generators
    line = gather_probe.k1_graph_case(generators.rmat(9, 4096, seed=1), 32,
                                      "cpu", host_ms)
    assert "m=4096" in line
    assert gather_probe.main([]) == 2     # no card: the probe refuses
