"""The port's counterpart of ``__graft_entry__.py::entry`` (21-42): one
batched raw-walk FORA top-10 step on a toy graph.

    from fora_tpu_torch.entry import entry
    step, args = entry("cuda:0")
    vals, ids = step(*args)      # [8, 10] each
"""

from __future__ import annotations

import torch

from .algo.fora import make_fora_fn
from .config import ForaConfig
from .graph import generators, to_device
from .ops.topk import topk_nodes


def entry(device):
    """``(step, example_args)``: ``step(sources, seed) -> (vals, ids)``,
    the top-10 of raw-walk FORA on ``erdos_renyi(512, 4096, seed=3)`` at
    eps 0.5, laid out on ``device``; the example is sources 0..7 and seed
    0."""
    g = generators.erdos_renyi(512, 4096, seed=3)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    fora = make_fora_fn(to_device(g, device=device), rcfg)

    def step(sources, seed):
        return topk_nodes(fora(sources, seed).ppr, 10)

    example_args = (torch.arange(8, dtype=torch.int32, device=device), 0)
    return step, example_args
