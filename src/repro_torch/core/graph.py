"""Bipartite graph model for multi-server job dispatching (paper Sec. 2).

Ports (left vertices) are job types; servers (right vertices) hold devices.
An edge (l, r) is a *channel*: type-l jobs may be served by server r, with a
per-channel device requirement vector ``A[:, e]`` over the K device types and
a cluster-wide capacity vector ``c`` (constraint (1) of the paper).

Host-side numpy, a copy of ``repro.core.graph``: the generator is
numpy-seeded, so the same seed gives bit-equal arrays in both packages.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["Instance", "generate_instance", "clipped_normal_mean",
           "instance_from_arrays"]


def _phi(z: float) -> float:
    return math.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def _Phi(z: float) -> float:
    return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))


def clipped_normal_mean(m: float, s: float, lo: float = 0.0, hi: float = 1.0) -> float:
    """Exact mean of clip(N(m, s), lo, hi) — the true channel valuation mean.

    The paper normalizes the net valuations Z̃ into [0,1]; the clipped mean
    is the ground truth ṽ, so the oracle and the regret accounting are
    consistent with what policies see.
    """
    if s <= 0.0:
        return min(max(m, lo), hi)
    a = (lo - m) / s
    b = (hi - m) / s
    pa, pb = _Phi(a), _Phi(b)
    mid = pb - pa
    inner = m * mid - s * (_phi(b) - _phi(a))
    return lo * pa + hi * (1.0 - pb) + inner


@dataclasses.dataclass(frozen=True)
class Instance:
    """A generated dispatching problem (paper Table 2 parameterization)."""

    n_ports: int  # |L|
    n_servers: int  # |R|
    edges: np.ndarray  # (E, 2) int32 — (l, r) per channel
    A: np.ndarray  # (K, E) int32 — device requirements per channel
    c: np.ndarray  # (K,) int32 — cluster-wide capacities
    cost: np.ndarray  # (E,) float32 — Σ_k f_k(a_k^e), the supply cost
    mu: np.ndarray  # (E,) float32 — gross valuation means (pre-clip)
    sigma: np.ndarray  # (E,) float32 — valuation noise std (= mu/2)
    v: np.ndarray  # (E,) float32 — true net means E[clip(N(mu-cost, sigma), 0, 1)]
    rho: np.ndarray  # (L,) float32 — per-port arrival probabilities
    alpha: float  # m = ceil(alpha * |E|)

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def n_device_types(self) -> int:
        return int(self.A.shape[0])

    @property
    def m(self) -> int:
        """The paper's max_t max_{x∈Ω} ‖x‖₁ surrogate: ⌈α|E|⌉."""
        return max(1, int(math.ceil(self.alpha * self.n_edges)))

    @property
    def port_of_edge(self) -> np.ndarray:
        return self.edges[:, 0].astype(np.int32)

    def edges_of_port(self, port: int) -> np.ndarray:
        return np.nonzero(self.edges[:, 0] == port)[0]


def generate_instance(
    seed: int = 0,
    n_ports: int = 8,
    n_servers: int = 40,
    edge_prob: float = 0.1,
    n_device_types: int = 3,
    a_lo: int = 1,
    a_hi: int = 2,
    c_lo: int = 1,
    c_hi: int = 2,
    rho: float = 0.9,
    alpha: float = 0.5,
    cost_scale: float | None = None,
) -> Instance:
    """Generate an instance with the paper's Table-2 defaults.

    ``A`` entries ~ U{a_lo..a_hi}, capacities ~ U{c_lo..c_hi} (clipped so every
    channel is individually feasible), edges ~ Bernoulli(edge_prob) with at
    least one channel per port, μ ~ U[0.1, 1], σ = μ/2, f_k(a) = w_k·a with
    w_k ~ |N(0.5, 0.1)| rescaled so the mean channel cost is ~0.3.
    """
    rng = np.random.default_rng(seed)
    K = n_device_types

    adj = rng.random((n_ports, n_servers)) < edge_prob
    for port in range(n_ports):  # every port keeps at least one channel
        if not adj[port].any():
            adj[port, rng.integers(n_servers)] = True
    ls, rs = np.nonzero(adj)
    edges = np.stack([ls, rs], axis=1).astype(np.int32)
    E = edges.shape[0]

    c = rng.integers(c_lo, c_hi + 1, size=K).astype(np.int32)
    A = rng.integers(a_lo, a_hi + 1, size=(K, E)).astype(np.int32)
    A = np.minimum(A, c[:, None])  # edge exists ⇒ solely servable

    w = np.abs(rng.normal(0.5, 0.1, size=K)).astype(np.float32)
    raw_cost = (w[:, None] * A).sum(axis=0)
    if cost_scale is None:
        cost_scale = 0.3 / max(float(raw_cost.mean()), 1e-9)
    cost = (raw_cost * cost_scale).astype(np.float32)

    mu = rng.uniform(0.1, 1.0, size=E).astype(np.float32)
    sigma = (mu / 2.0).astype(np.float32)
    v = np.array(
        [clipped_normal_mean(float(mu[e] - cost[e]), float(sigma[e]))
         for e in range(E)],
        dtype=np.float32,
    )

    return Instance(
        n_ports=n_ports,
        n_servers=n_servers,
        edges=edges,
        A=A,
        c=c,
        cost=cost,
        mu=mu,
        sigma=sigma,
        v=v,
        rho=np.full(n_ports, rho, dtype=np.float32),
        alpha=alpha,
    )


def instance_from_arrays(**fields) -> Instance:
    """Build an :class:`Instance` from another package's instance fields.

    Takes the dataclass fields by name (``n_ports``, ``n_servers``,
    ``edges``, ``A``, ``c``, ``cost``, ``mu``, ``sigma``, ``v``, ``rho``,
    ``alpha``) with arrays as numpy, e.g. ``instance_from_arrays(
    **dataclasses.asdict(jax_instance))``, and copies them with the dtypes
    this package uses.
    """
    names = {f.name for f in dataclasses.fields(Instance)}
    missing, extra = names - fields.keys(), fields.keys() - names
    if missing or extra:
        raise ValueError(f"instance fields: missing {sorted(missing)}, "
                         f"unknown {sorted(extra)}")
    i32 = ("edges", "A", "c")
    f32 = ("cost", "mu", "sigma", "v", "rho")
    return Instance(
        n_ports=int(fields["n_ports"]),
        n_servers=int(fields["n_servers"]),
        alpha=float(fields["alpha"]),
        **{k: np.array(fields[k], dtype=np.int32) for k in i32},
        **{k: np.array(fields[k], dtype=np.float32) for k in f32},
    )
