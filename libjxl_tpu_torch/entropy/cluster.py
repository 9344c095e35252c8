"""Greedy histogram clustering for context maps.

Reference: lib/jxl/enc_cluster.{h,cc} FastClusterHistograms /
ClusterHistograms — entropy-cost driven clustering with kClustersLimit.
Exact clustering is encoder freedom (not bitstream-visible). This
implementation mirrors the reference's two-stage scheme: a vectorized
farthest-point pass picks cluster centers and assigns every histogram
to its cheapest center, then an exact agglomerative pass merges the
(few) resulting clusters while merging saves bits.
"""

from __future__ import annotations

import heapq

import numpy as np

# Approximate cost (bits) of storing one extra histogram header.
_HEADER_BITS = 40.0


def _entropy_cost(counts: np.ndarray) -> float:
    total = counts.sum()
    if total == 0:
        return 0.0
    nz = counts[counts > 0].astype(np.float64)
    return float(total * np.log2(total) - np.sum(nz * np.log2(nz)))


def _cost_rows(a: np.ndarray) -> np.ndarray:
    """Entropy cost of each histogram along the last axis, vectorized."""
    total = a.sum(axis=-1)
    safe = np.maximum(a, 1.0)
    xlogx = (a * np.log2(safe)).sum(axis=-1)
    return np.where(total > 0, total * np.log2(np.maximum(total, 1.0)), 0.0) \
        - xlogx


def _greedy_merge(counts: list[np.ndarray], max_clusters: int,
                  ) -> list[int]:
    """Exact agglomerative merging; returns parent map (index -> root)."""
    n = len(counts)
    parents = list(range(n))
    work = [c.astype(np.float64) for c in counts]
    costs = [_entropy_cost(c) for c in work]
    alive = [True] * n

    def merge_cost(i: int, j: int) -> float:
        return _entropy_cost(work[i] + work[j]) - costs[i] - costs[j]

    heap: list[tuple[float, int, int]] = []
    for i in range(n):
        for j in range(i + 1, n):
            heapq.heappush(heap, (merge_cost(i, j), i, j))

    num_live = n
    while num_live > 1 and heap:
        cost, i, j = heapq.heappop(heap)
        if not (alive[i] and alive[j]):
            continue
        if num_live <= max_clusters and cost > _HEADER_BITS:
            break
        work[i] = work[i] + work[j]
        costs[i] = _entropy_cost(work[i])
        alive[j] = False
        parents[j] = i
        num_live -= 1
        for k in range(n):
            if alive[k] and k != i:
                a, b = (i, k) if i < k else (k, i)
                heapq.heappush(heap, (merge_cost(a, b), a, b))

    def find(i: int) -> int:
        while parents[i] != i:
            parents[i] = parents[parents[i]]
            i = parents[i]
        return i

    return [find(i) for i in range(n)]


def cluster_histograms(histograms: list[np.ndarray], max_clusters: int = 64,
                       ) -> tuple[list[int], list[np.ndarray]]:
    """Returns (context_map, clustered_histograms)."""
    n = len(histograms)
    width = max((len(h) for h in histograms), default=1)
    a = np.zeros((n, max(width, 1)), np.float64)
    for i, h in enumerate(histograms):
        a[i, :len(h)] = h
    # Trim trailing all-zero symbols: alphabets are sparse and the
    # pairwise cost matrices scale linearly with width.
    used = np.nonzero(a.any(axis=0))[0]
    if len(used) and used[-1] + 1 < a.shape[1]:
        a = np.ascontiguousarray(a[:, :used[-1] + 1])
    width = a.shape[1]
    all_totals = a.sum(axis=-1)
    nonempty = np.nonzero(all_totals > 0)[0]

    if len(nonempty) == 0:
        return [0] * n, [np.zeros(width, np.int64)]

    # Heavy math runs only over nonempty contexts (often a small
    # fraction of the context space), in float32.
    full_a = a
    a = np.ascontiguousarray(a[nonempty], np.float32)
    totals = all_totals[nonempty]
    self_cost = _cost_rows(a)

    # ---- stage 1: farthest-point center selection (vectorized) ----
    first = int(np.argmax(totals))
    centers = [first]

    def cost_to(c: int) -> np.ndarray:
        return _cost_rows(a + a[c]) - self_cost - self_cost[c]

    dist = cost_to(first)
    dist[first] = -np.inf
    while len(centers) < max_clusters:
        i = int(np.argmax(dist))
        if dist[i] <= _HEADER_BITS:
            break
        centers.append(i)
        np.minimum(dist, cost_to(i), out=dist)
        dist[i] = -np.inf

    # ---- assign every histogram to its cheapest center ----
    c_arr = a[centers]                                      # (m, k)
    merged = a[:, None, :] + c_arr[None]                    # (ne, m, k)
    mcost = _cost_rows(merged) - self_cost[:, None] - self_cost[centers][None]
    sub_assign = np.argmin(mcost, axis=1)
    for ci, c in enumerate(centers):
        sub_assign[c] = ci
    # Scatter back to the full context space; empties join cluster of
    # the first center.
    assign = np.full(n, int(sub_assign[first]), np.int64)
    assign[nonempty] = sub_assign
    a = full_a

    m = len(centers)
    clustered = [np.zeros(width, np.int64) for _ in range(m)]
    for i in range(n):
        clustered[assign[i]] += a[i].astype(np.int64)

    # ---- stage 2: exact merge among the few clusters ----
    parent = _greedy_merge(clustered, max_clusters)
    root_index: dict[int, int] = {}
    remap = [0] * m
    final: list[np.ndarray] = []
    final_counts: list[np.ndarray] = []
    for ci in range(m):
        r = parent[ci]
        if r not in root_index:
            root_index[r] = len(final_counts)
            final_counts.append(np.zeros(width, np.int64))
        remap[ci] = root_index[r]
    for ci in range(m):
        final_counts[remap[ci]] += clustered[ci]

    # Renumber in order of first appearance in the context map.
    order: dict[int, int] = {}
    context_map: list[int] = []
    for i in range(n):
        c = remap[assign[i]]
        if c not in order:
            order[c] = len(order)
        context_map.append(order[c])
    final = [None] * len(order)  # type: ignore[list-item]
    for c, pos in order.items():
        final[pos] = final_counts[c]
    return context_map, final
