"""Parameter derivation for FORA-style approximate PPR.

The same (epsilon, delta, p_f) -> (rmax, omega) derivation as
``fora_tpu/config.py`` (the port carries its own copy so that it loads
nothing of the JAX package; ``tests/test_torch_host.py`` holds the two
equal).  For every target t with pi(s, t) > delta,
``|pi_hat(s,t) - pi(s,t)| <= eps * pi(s,t)`` with probability >= 1 - p_f,
where

  omega  = rsum * (2*eps/3 + 2) * ln(2/p_f) / (eps^2 * delta)
  rmax   = rmax_scale * eps * sqrt(delta / (m * (2*eps/3 + 2) * ln(2/p_f)))
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ForaConfig:
    """All knobs of a FORA query; ``resolved`` binds a graph size."""

    alpha: float = 0.2          # teleport / stop probability
    epsilon: float = 0.5        # relative error bound
    delta: Optional[float] = None   # guarantee threshold; default 1/n
    pfail: Optional[float] = None   # failure probability; default 1/n
    rmax_scale: float = 1.0     # constant in front of the balanced rmax
    k: int = 50                 # top-k size for topk queries
    max_push_iters: int = 200    # cap on push supersteps per push
    max_walk_hops: int = 64      # cap on walk length (P[len>L]=(1-a)^L)
    walk_multiplier: float = 1.0  # scale on omega (for sweeps)

    def resolved(self, n: int, m: int) -> "ResolvedConfig":
        """Bind graph size (n nodes, m edges) and derive rmax / omega."""
        delta = self.delta if self.delta is not None else 1.0 / n
        pfail = self.pfail if self.pfail is not None else 1.0 / n
        eps = self.epsilon
        c = (2.0 * eps / 3.0 + 2.0) * math.log(2.0 / pfail)
        # omega for rsum = 1; at query time scale by the actual rsum.
        omega_unit = c / (eps * eps * delta)
        rmax = self.rmax_scale * eps * math.sqrt(delta / (m * c))
        return ResolvedConfig(
            alpha=self.alpha, epsilon=eps, delta=delta, pfail=pfail,
            rmax=rmax, omega_unit=omega_unit * self.walk_multiplier,
            k=self.k, n=n, m=m, max_push_iters=self.max_push_iters,
            max_walk_hops=self.max_walk_hops)


@dataclasses.dataclass(frozen=True)
class ResolvedConfig:
    """A ForaConfig bound to a concrete graph: rmax/omega are numbers."""

    alpha: float
    epsilon: float
    delta: float
    pfail: float
    rmax: float
    omega_unit: float   # omega for rsum == 1
    k: int
    n: int
    m: int
    max_push_iters: int
    max_walk_hops: int

    def omega(self, rsum: float) -> float:
        return rsum * self.omega_unit

    def with_delta(self, delta: float) -> "ResolvedConfig":
        """Re-derive rmax/omega at a new delta (top-k refinement)."""
        eps = self.epsilon
        c = (2.0 * eps / 3.0 + 2.0) * math.log(2.0 / self.pfail)
        rmax_scale = self.rmax / (eps * math.sqrt(self.delta / (self.m * c)))
        return dataclasses.replace(
            self,
            delta=delta,
            rmax=rmax_scale * eps * math.sqrt(delta / (self.m * c)),
            omega_unit=c / (eps * eps * delta),
        )
