"""Graph containers + a real neighbor sampler (minibatch_lg needs fanout 15-10),
a copy of ``repro.data.graph``: numpy only, so every array is bit for bit
``repro``'s.

Message passing (``models.gnn``) is a gather and an ``index_add_`` over an edge
index; samplers return fixed-size padded edge lists with a validity mask, so a
train step's shapes do not depend on the draw.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Graph:
    """edge_index: [2, E] int32 (src, dst); features [N, F]; labels [N]."""
    edge_index: np.ndarray
    features: np.ndarray
    labels: np.ndarray
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return self.edge_index.shape[1]


def random_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int = 16,
                 seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    # power-law-ish degree: preferential attachment approximation
    dst = rng.integers(0, n_nodes, n_edges)
    src = (rng.zipf(1.6, n_edges) - 1) % n_nodes
    edge_index = np.stack([src, dst]).astype(np.int32)
    feats = rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    return Graph(edge_index, feats, labels, n_nodes)


def batched_molecules(n_graphs: int, nodes_per: int, edges_per: int, d_feat: int,
                      seed: int = 0) -> Graph:
    """Disjoint union of small graphs (the `molecule` shape)."""
    rng = np.random.default_rng(seed)
    srcs, dsts, feats, labels = [], [], [], []
    for g in range(n_graphs):
        off = g * nodes_per
        srcs.append(rng.integers(0, nodes_per, edges_per) + off)
        dsts.append(rng.integers(0, nodes_per, edges_per) + off)
        feats.append(rng.standard_normal((nodes_per, d_feat)).astype(np.float32))
        labels.append(rng.integers(0, 2, nodes_per))
    edge_index = np.stack([np.concatenate(srcs), np.concatenate(dsts)]).astype(np.int32)
    return Graph(edge_index, np.concatenate(feats),
                 np.concatenate(labels).astype(np.int32), n_graphs * nodes_per)


def partition_edges_by_dst(graph: Graph, n_parts: int, pad_factor: float = 1.2
                           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Partition edges so part p holds exactly the edges whose dst lies in node
    range p (range-sharded nodes), each part padded to a common capacity.

    Returns (edge_src [n_parts*cap], edge_dst [n_parts*cap], edge_mask) ready for
    the dst-partitioned shard_map message passing (models/gnn.py): every scatter
    is then shard-local.  Capacity absorbs degree skew; overflowing edges are
    dropped with a warning counter (real pipelines re-balance ranges instead).
    """
    src, dst = graph.edge_index
    n_local = -(-graph.n_nodes // n_parts)
    owner = dst // n_local
    order = np.argsort(owner, kind="stable")
    src, dst, owner = src[order], dst[order], owner[order]
    counts = np.bincount(owner, minlength=n_parts)
    cap = int(counts.mean() * pad_factor) + 1
    out_src = np.zeros(n_parts * cap, np.int32)
    out_dst = np.zeros(n_parts * cap, np.int32)
    mask = np.zeros(n_parts * cap, bool)
    start = 0
    for p in range(n_parts):
        take = min(int(counts[p]), cap)
        out_src[p * cap: p * cap + take] = src[start: start + take]
        out_dst[p * cap: p * cap + take] = dst[start: start + take]
        out_dst[p * cap + take: (p + 1) * cap] = p * n_local  # in-range padding
        mask[p * cap: p * cap + take] = True
        start += int(counts[p])
    return out_src, out_dst, mask


class CSRNeighborTable:
    """CSR adjacency for O(1) uniform neighbor sampling."""

    def __init__(self, graph: Graph):
        src, dst = graph.edge_index
        order = np.argsort(dst, kind="stable")
        self.sorted_src = src[order]
        self.indptr = np.zeros(graph.n_nodes + 1, np.int64)
        np.add.at(self.indptr, dst + 1, 1)
        self.indptr = np.cumsum(self.indptr)

    def sample(self, nodes: np.ndarray, fanout: int, rng) -> tuple[np.ndarray, np.ndarray]:
        """For each node draw `fanout` neighbors (with replacement; isolated nodes
        yield self-loops).  Returns (neighbors [len(nodes)*fanout], mask)."""
        lo = self.indptr[nodes]
        hi = self.indptr[nodes + 1]
        deg = (hi - lo)
        draw = rng.integers(0, np.maximum(deg, 1)[:, None], (nodes.size, fanout))
        nbr = self.sorted_src[np.minimum(lo[:, None] + draw, len(self.sorted_src) - 1)]
        has = (deg > 0)[:, None]
        nbr = np.where(has, nbr, nodes[:, None])  # self-loop fallback
        return nbr.reshape(-1).astype(np.int32), np.broadcast_to(has, nbr.shape).reshape(-1)


@dataclass
class SampledSubgraph:
    """Fixed-size k-hop sampled subgraph (layer-wise, GraphSAGE style)."""
    node_ids: np.ndarray       # [n_sub] global ids (padded with 0)
    features: np.ndarray       # [n_sub, F]
    labels: np.ndarray         # [n_seeds]
    edge_src: np.ndarray       # [n_sub_edges] local indices
    edge_dst: np.ndarray
    edge_mask: np.ndarray
    n_seeds: int


def sample_subgraph(graph: Graph, table: CSRNeighborTable, seeds: np.ndarray,
                    fanouts: tuple[int, ...], seed: int = 0) -> SampledSubgraph:
    """Layer-wise sampling: frontier_0 = seeds; frontier_{l+1} = fanout[l] neighbors
    of frontier_l.  Local edges connect each sampled neighbor to its anchor."""
    rng = np.random.default_rng(seed)
    frontiers = [seeds.astype(np.int32)]
    srcs, dsts, masks = [], [], []
    offset = 0
    for fo in fanouts:
        anchors = frontiers[-1]
        nbr, mask = table.sample(anchors, fo, rng)
        next_off = offset + anchors.size
        local_dst = np.repeat(np.arange(anchors.size), fo) + offset
        local_src = np.arange(nbr.size) + next_off
        srcs.append(local_src)
        dsts.append(local_dst)
        masks.append(mask)
        frontiers.append(nbr)
        offset = next_off
    node_ids = np.concatenate(frontiers)
    return SampledSubgraph(
        node_ids=node_ids,
        features=graph.features[node_ids],
        labels=graph.labels[seeds],
        edge_src=np.concatenate(srcs).astype(np.int32),
        edge_dst=np.concatenate(dsts).astype(np.int32),
        edge_mask=np.concatenate(masks),
        n_seeds=seeds.size,
    )
