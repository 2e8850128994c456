"""Hop-distance topology of the machine the experts are placed on (own copy
of the part of ``repro/core/topology.py`` the training launcher needs).

The paper's machine model: *locations* (cores) grouped into *nodes* (NUMA
domains) with an integer hop-distance matrix between nodes. The training
launcher builds its MoE steal table from the modelled ``tpu_pod_2d`` (or
``uma`` for one expert), exactly as the JAX launcher does, so both packages
route with the same table. A topology of NVIDIA cards joins with the
distribution slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Topology", "tpu_pod_2d", "uma"]


@dataclasses.dataclass(frozen=True)
class Topology:
    """A non-uniform machine: cores grouped into nodes, node hop distances.

    Attributes:
      name: human-readable identifier.
      core_node: (num_cores,) int array — node id of each core.
      node_distance: (num_nodes, num_nodes) int array of hop distances,
        zero on the diagonal, symmetric. Cores on one node are 0 hops
        apart.
      link_bandwidth: bandwidth (bytes/s) of a 1-hop link.
      hop_latency: per-hop latency weight for the NUMA factor model.
    """

    name: str
    core_node: np.ndarray
    node_distance: np.ndarray
    link_bandwidth: float = 50e9
    hop_latency: float = 1.0

    def __post_init__(self):
        cn = np.asarray(self.core_node, dtype=np.int64)
        nd = np.asarray(self.node_distance, dtype=np.int64)
        object.__setattr__(self, "core_node", cn)
        object.__setattr__(self, "node_distance", nd)
        if nd.ndim != 2 or nd.shape[0] != nd.shape[1]:
            raise ValueError(f"node_distance must be square, got {nd.shape}")
        if not np.array_equal(nd, nd.T):
            raise ValueError("node_distance must be symmetric")
        if np.any(np.diag(nd) != 0):
            raise ValueError("node_distance diagonal must be zero")
        if cn.min(initial=0) < 0 or cn.max(initial=0) >= nd.shape[0]:
            raise ValueError("core_node indexes outside node_distance")

    @property
    def num_cores(self) -> int:
        return int(self.core_node.shape[0])

    @property
    def num_nodes(self) -> int:
        return int(self.node_distance.shape[0])

    def core_distance(self, a: int, b: int) -> int:
        """Hop distance between two cores (0 if co-located on a node)."""
        return int(self.node_distance[self.core_node[a], self.core_node[b]])

    def core_distance_matrix(self) -> np.ndarray:
        """(num_cores, num_cores) hop distances, cached read-only."""
        m = self.__dict__.get("_core_distance_matrix")
        if m is None:
            m = self.node_distance[self.core_node][:, self.core_node]
            m.flags.writeable = False
            object.__setattr__(self, "_core_distance_matrix", m)
        return m


def uma(num_cores: int, name: str = "uma") -> Topology:
    """Uniform machine: one node, all cores local (paper §II baseline)."""
    return Topology(name, np.zeros(num_cores, np.int64),
                    np.zeros((1, 1), np.int64))


def tpu_pod_2d(rows: int, cols: int, name: str | None = None,
               wrap: bool = True, link_bandwidth: float = 50e9) -> Topology:
    """A 2-D (twisted) torus of chips, each chip its own node; hop
    distance is the torus manhattan distance."""
    n = rows * cols
    R, C = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    coords = np.stack([R.ravel(), C.ravel()], axis=1)  # (n, 2)
    dr = np.abs(coords[:, None, 0] - coords[None, :, 0])
    dc = np.abs(coords[:, None, 1] - coords[None, :, 1])
    if wrap:
        dr = np.minimum(dr, rows - dr)
        dc = np.minimum(dc, cols - dc)
    nd = (dr + dc).astype(np.int64)
    return Topology(name or f"tpu-pod-{rows}x{cols}",
                    np.arange(n, dtype=np.int64), nd,
                    link_bandwidth=link_bandwidth)
