"""The configurations' graphs, made on the device from the run's seed.

``kronecker_edges`` is the Graph500 Kronecker (R-MAT) generator in torch:
each of the ``edgefactor << scale`` edges picks one quadrant (A, B, C, D)
per bit of its endpoints, node ids are permuted, and a self-loop moves
its head to the next node, as ``fora_tpu_torch/graph/generators.py::rmat``
does with numpy on the host (other random draws, the same law).  A few
large calls on a ``torch.Generator`` of the device: about a second at
scale 22 on a card, where the numpy generator takes minutes.

``csr_fields`` lays the edge list out as the program's ``CSRGraph``
fields, in the form ``graph/csr.py::from_edges`` gives (stable sorts by
source and by destination), with the sorts on the device.  Nothing here
imports the program: the harness builds its ``CSRGraph`` from the fields.
"""

from __future__ import annotations

import torch

SEED_MASK = (1 << 64) - 1


def kronecker_edges(scale: int, edgefactor: int, a: float, b: float,
                    c: float, seed: int, device) -> tuple:
    """(src, dst) int64 [edgefactor * 2^scale] on ``device``."""
    n = 1 << scale
    m = edgefactor * n
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for _ in range(scale):
        u = torch.rand(m, generator=gen, dtype=torch.float64, device=device)
        # quadrant q: 0 (0,0) below a, 1 (0,1) below a+b, 2 (1,0) below
        # a+b+c, else 3 (1,1); the source bit is q >> 1, the head's q & 1
        hi = u >= a + b
        lo = ((u >= a) & ~hi) | (u >= a + b + c)
        src.mul_(2).add_(hi)
        dst.mul_(2).add_(lo)
        del u, hi, lo
    perm = torch.randperm(n, generator=gen, device=device)
    src, dst = perm[src], perm[dst]
    del perm
    loop = src == dst
    dst = torch.where(loop, (dst + 1) % n, dst)
    return src, dst


def csr_fields(src: torch.Tensor, dst: torch.Tensor, n: int) -> dict:
    """The out-CSR and the dst-sorted in-edges of (src, dst) as host int32
    arrays named as ``CSRGraph``'s fields: parallel edges and self-loops
    kept, each order stable, as ``from_edges(dedup=False)``."""
    order = torch.sort(src, stable=True).indices
    out_indices = dst[order].to(torch.int32)
    del order
    out_deg = torch.bincount(src, minlength=n)
    out_indptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    torch.cumsum(out_deg, 0, out=out_indptr[1:])
    in_dst, order_in = torch.sort(dst, stable=True)
    in_src = src[order_in].to(torch.int32)
    del order_in
    in_deg = torch.bincount(dst, minlength=n)

    def host(x):
        return x.to(torch.int32).cpu().numpy()
    return dict(out_indptr=host(out_indptr), out_indices=host(out_indices),
                in_src=host(in_src), in_dst=host(in_dst),
                out_deg=host(out_deg), in_deg=host(in_deg))


def unique_edges(src: torch.Tensor, dst: torch.Tensor, n: int) -> int:
    """Distinct (src, dst) pairs: the in-edges of the merged layout."""
    return int(torch.unique(src * n + dst).numel())


def make_graph(spec: dict, device, seed: int) -> tuple:
    """The configuration's graph ``spec``: ((src, dst) int64 on
    ``device``, n), drawn from ``seed``."""
    if spec["generator"] != "kronecker":
        raise ValueError(f"no generator {spec['generator']!r}")
    src, dst = kronecker_edges(spec["scale"], spec["edgefactor"], spec["a"],
                               spec["b"], spec["c"], seed, device)
    return (src, dst), 1 << spec["scale"]
