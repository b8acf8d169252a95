"""P3's probe on the card: how fast is a per-edge row accumulate over an
unsorted edge list, with the tile and the accumulator resident in L2,
against the destination-row gather (K1) on the same edges and on the
bench graph?

    python -m fora_tpu_torch.probes.gather_probe [--device cuda:0]

Port of ``scripts/pallas_gather_probe.py``, which asked the same of a TPU
kernel with both operands in VMEM.  On the card the answer decides K1's
next design: K1 sums each destination row in one warp without atomics,
and splitting long rows over several warps would need atomics like P3's.
It prints one line per run (kernel ms from CUDA events, M edges/s, and
the effective row traffic E * B * 4 bytes per second):

  1. P3 (``row_scatter_add``) at the Pallas probe's shapes: H = 8192 tile
     rows, N_DST = 4096 accumulator rows, E = 2^18 edges drawn as the
     Pallas probe draws them (numpy seed 0), at B = 128, 64 and 32;
     checked against its plain version (rtol 1e-4, atol 1e-5);
  2. K1 (``gather_scatter_add``) on the same edges sorted by destination,
     which computes the same sum (rtol 1e-4, atol 1e-5 against P3);
  3. K1 over bench.py's graph (RMAT n = 2^19, m = 2^23, seed 7, every
     in-edge) at B = 128, 64 and 32: the card's gather rate.

It needs a CUDA card and fails without one.  The case functions take a
device and a timer, so the CPU tests run them on the plain versions.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from ..ops.gather import (gather_scatter_add, row_scatter_add,
                          row_scatter_add_plain)

H, N_DST, E_PROBE, SEED = 8192, 4096, 1 << 18, 0
WIDTHS = (128, 64, 32)
BENCH_GRAPH = dict(n_log2=19, m=1 << 23, seed=7)
RTOL, ATOL = 1e-4, 1e-5


def probe_edges(B: int, device, e_total: int = E_PROBE, seed: int = SEED):
    """(src [E] i32 in [0, H), dst [E] i32 in [0, N_DST), tile [H, B] f32)
    drawn in the Pallas probe's order from numpy's generator."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, H, e_total).astype(np.int32)
    dst = rng.integers(0, N_DST, e_total).astype(np.int32)
    tile = rng.random((H, B), np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (src, dst, tile))


def by_destination(src: torch.Tensor, dst: torch.Tensor, n_rows: int):
    """The edge list as a CSR by destination: (indptr [n_rows+1] i32,
    sources in destination order)."""
    order = torch.argsort(dst, stable=True)
    rows = torch.arange(n_rows + 1, dtype=torch.int32, device=dst.device)
    indptr = torch.searchsorted(dst[order].contiguous(), rows,
                                out_int32=True)
    return indptr, src[order].contiguous()


def max_err(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max |got - want|; raises unless every entry is within RTOL/ATOL."""
    err = (got - want).abs()
    if bool((err > ATOL + RTOL * want.abs()).any()):
        raise AssertionError(f"{name}: differs beyond rtol {RTOL} atol "
                             f"{ATOL} (max abs err {float(err.max()):.3e})")
    return float(err.max())


def rate_line(name: str, B: int, edges: int, ms: float) -> str:
    per_s = edges / (ms * 1e-3)
    return (f"{name} B={B}: {ms:.4f} ms for {edges} edges -> "
            f"{per_s / 1e6:.1f} M edges/s ({per_s * B * 4 / 1e9:.1f} GB/s "
            f"effective row traffic)")


def p3_case(B: int, device, time_ms, e_total: int = E_PROBE) -> dict:
    """P3 at the probe's shapes and width B against its plain version and
    against K1 on the same edges sorted by destination; times all
    three.  Returns the errors, the times and the rate lines."""
    src, dst, tile = probe_edges(B, device, e_total)
    zeros = lambda: torch.zeros((N_DST, B), dtype=torch.float32,  # noqa: E731
                                device=device)
    got = row_scatter_add(zeros(), tile, src, dst)
    err_plain = max_err(f"P3 B={B} vs plain", got,
                        row_scatter_add_plain(zeros(), tile, src, dst))
    indptr, src_d = by_destination(src, dst, N_DST)
    err_k1 = max_err(f"K1 B={B} vs P3",
                     gather_scatter_add(zeros(), tile, indptr, src_d), got)
    acc = zeros()
    out = dict(B=B, edges=e_total, err_plain=err_plain, err_k1=err_k1,
               ms=time_ms(lambda: row_scatter_add(acc, tile, src, dst)),
               plain_ms=time_ms(lambda: row_scatter_add_plain(acc, tile,
                                                              src, dst)),
               k1_ms=time_ms(lambda: gather_scatter_add(acc, tile, indptr,
                                                        src_d)))
    out["lines"] = [
        rate_line("P3 row_scatter_add", B, e_total, out["ms"]),
        rate_line("P3 plain index_add_", B, e_total, out["plain_ms"]),
        rate_line("K1 gather_scatter_add, same edges by destination", B,
                  e_total, out["k1_ms"])]
    return out


def k1_graph_case(g, B: int, device, time_ms) -> str:
    """K1 over every in-edge of the host graph ``g`` at width B (random
    values, seed 0): its rate line."""
    from ..graph import to_device
    dg = to_device(g, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    values = torch.rand((g.n, B), generator=gen, device=device)
    acc = torch.zeros_like(values)
    ms = time_ms(lambda: gather_scatter_add(acc, values, dg.in_indptr,
                                            dg.in_src))
    return rate_line(f"K1 gather_scatter_add, RMAT n={g.n} m={g.m}", B, g.m,
                     ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_probe: no CUDA device; the probe measures the card",
              file=sys.stderr)
        return 2
    from ..graph import generators
    from ..utils.timing import cuda_ms
    dev = torch.device(args.device)
    print(f"device: {torch.cuda.get_device_name(dev)}; " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[dev.index or 0])
    for B in WIDTHS:
        res = p3_case(B, dev, cuda_ms)
        print(f"P3 B={B}: max abs err {res['err_plain']:.3e} vs plain, "
              f"{res['err_k1']:.3e} vs K1")
        for line in res["lines"]:
            print(line)
    g = generators.rmat(**BENCH_GRAPH)
    for B in WIDTHS:
        print(k1_graph_case(g, B, dev, cuda_ms))
    return 0


if __name__ == "__main__":
    sys.exit(main())
