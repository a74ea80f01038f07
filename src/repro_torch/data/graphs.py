"""Graph generators and the neighbour sampler for the PNA cells.

Port of ``repro/data/graphs.py`` (numpy, on the host): the same draws
from the same ``np.random.default_rng`` streams, so every array is
bit-equal to the reference's for the same seed.  ``minibatch_lg`` needs
a real neighbour sampler (fanout 15-10 over a 232,965-node, ~114.6M-edge
graph): the graph stays in CSR on the host and each sampled block is an
edge list over block-local ids (the GraphSAGE pipeline).

Three host costs of the reference are replaced where the arrays stay
bit-equal: the stable sort of the edges by source is radix passes over
16-bit digits (numpy's stable sort of 64-bit keys is a merge sort),
the CSR row counts use ``np.bincount`` (``np.add.at`` over 114.6M
edges), and the block-local remap ``np.searchsorted`` over the sorted
unique ``nodes`` (a Python dict a node).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Graph:
    """CSR adjacency + features / labels."""
    indptr: np.ndarray      # (N+1,) int64
    indices: np.ndarray     # (E,) int32 neighbour ids
    features: np.ndarray    # (N, F) float32 (may be empty: id embedding)
    labels: np.ndarray      # (N,) int32

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.indices.shape[0]

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)


def stable_argsort(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` for non-negative integer keys:
    least-significant-digit passes over 16-bit digits, each a stable
    (radix) sort of uint16 keys."""
    order = None
    top = int(keys.max()) if keys.size else 0
    shift = 0
    while True:
        k = keys if order is None else keys[order]
        digit = ((k >> shift) & 0xFFFF).astype(np.uint16)
        step = np.argsort(digit, kind="stable")
        order = step if order is None else order[step]
        shift += 16
        if top >> shift == 0:
            return order


def random_graph(num_nodes: int, avg_degree: int, feat_dim: int,
                 num_classes: int = 16, seed: int = 0,
                 power_law: bool = True) -> Graph:
    """Power-law (zipf-weighted destinations) or uniform random graph."""
    rng = np.random.default_rng(seed)
    num_edges = num_nodes * avg_degree
    if power_law:
        w = (np.arange(num_nodes) + 1.0) ** -0.8
        w /= w.sum()
        dst = rng.choice(num_nodes, num_edges, p=w)
    else:
        dst = rng.integers(0, num_nodes, num_edges)
    src = rng.integers(0, num_nodes, num_edges)
    dst = dst[stable_argsort(src)]          # edges grouped by source
    indptr = np.zeros(num_nodes + 1, np.int64)
    indptr[1:] = np.bincount(src, minlength=num_nodes)
    indptr = np.cumsum(indptr)
    feats = rng.standard_normal((num_nodes, feat_dim)).astype(np.float32) \
        if feat_dim else np.zeros((num_nodes, 0), np.float32)
    # labels correlated with the features, so training has signal
    if feat_dim:
        proj = rng.standard_normal((feat_dim, num_classes))
        labels = (feats @ proj).argmax(-1).astype(np.int32)
    else:
        labels = rng.integers(0, num_classes, num_nodes).astype(np.int32)
    return Graph(indptr=indptr, indices=dst.astype(np.int32),
                 features=feats, labels=labels)


def to_edge_list(g: Graph) -> tuple[np.ndarray, np.ndarray]:
    """CSR -> (src (E,), dst (E,)) COO edge list."""
    src = np.repeat(np.arange(g.num_nodes, dtype=np.int32), g.degrees())
    return src, g.indices


def padded_subgraph(g: Graph, seeds: np.ndarray, fanouts: tuple[int, ...],
                    seed: int = 0) -> dict:
    """One sampled training block: node set = seeds U sampled neighbours,
    edges (src, dst) over block-local ids; models run full message
    passing on the block and read out the seed rows."""
    rng = np.random.default_rng(seed)
    frontier = seeds.astype(np.int64)
    all_src, all_dst = [], []
    nodes = frontier
    degrees = g.degrees()
    for fanout in fanouts:
        deg = degrees[frontier]
        offs = rng.integers(0, np.maximum(deg, 1)[:, None]
                            .repeat(fanout, axis=1))
        base = g.indptr[frontier][:, None]
        nbr = g.indices[np.minimum(base + offs,
                                   g.indptr[frontier + 1][:, None] - 1)]
        nbr = np.where(deg[:, None] > 0, nbr,
                       frontier[:, None]).astype(np.int64)
        all_src.append(nbr.reshape(-1))
        all_dst.append(np.repeat(frontier, fanout))
        frontier = np.unique(nbr)
        nodes = np.unique(np.concatenate([nodes, frontier]))
    src = np.concatenate(all_src)
    dst = np.concatenate(all_dst)
    # block-local ids: the rank in the sorted unique node set
    return {
        "node_ids": nodes.astype(np.int32),
        "features": g.features[nodes] if g.features.size else
        np.zeros((len(nodes), 0), np.float32),
        "src": np.searchsorted(nodes, src).astype(np.int32),
        "dst": np.searchsorted(nodes, dst).astype(np.int32),
        "seed_local": np.searchsorted(
            nodes, seeds.astype(np.int64)).astype(np.int32),
        "labels": g.labels[seeds],
    }


def molecule_batch(batch: int, nodes: int, edges: int, feat_dim: int,
                   seed: int = 0) -> dict:
    """Batched small graphs (the molecule cell): a block-diagonal edge
    list."""
    rng = np.random.default_rng(seed)
    n_tot = batch * nodes
    src = rng.integers(0, nodes, (batch, edges)) \
        + np.arange(batch)[:, None] * nodes
    dst = rng.integers(0, nodes, (batch, edges)) \
        + np.arange(batch)[:, None] * nodes
    feats = rng.standard_normal((n_tot, feat_dim)).astype(np.float32)
    graph_ids = np.repeat(np.arange(batch, dtype=np.int32), nodes)
    labels = rng.random(batch).astype(np.float32)  # regression target
    return {"features": feats, "src": src.reshape(-1).astype(np.int32),
            "dst": dst.reshape(-1).astype(np.int32),
            "graph_ids": graph_ids, "labels": labels}
