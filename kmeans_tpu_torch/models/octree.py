"""Octree colour quantizer (host numpy), for `algo=Algorithm.OCTREE`.

A copy of `kmeans_tpu/models/octree.py` (`_Node:30`, `ColorTree:66`,
`extract_palette_octree:168`), kept inside the port because importing
`kmeans_tpu` imports JAX. It is exact integer arithmetic, so the same
input gives the reference's palette.

Colours descend an 8-level octree on their RGB bit-planes; only depth-8
leaves accumulate (sum-RGB and pixel count). `reduce` merges the least
important populated node into its parent until at most `color_count`
remain. Importance is ordered by `(child_count, pixel_count >> level,
node_id)` ascending. Output colours are the integer-truncated channel
means, sorted lexicographically by (r, g, b, a) and deduplicated.
Identical pixels are aggregated up front (numpy unique and counts) and
inserted in first-occurrence order, so node ids, and with them the merge
order's last tie-break, follow the pixel scan.
"""

from __future__ import annotations

import bisect

import numpy as np

MAX_DEPTH = 8


class _Node:
    __slots__ = (
        "node_id",
        "level",
        "color_index",
        "parent",
        "children",
        "child_count",
        "r",
        "g",
        "b",
        "count",
    )

    def __init__(self, node_id: int, parent, color_index: int, level: int):
        self.node_id = node_id
        self.level = level
        self.color_index = color_index
        self.parent = parent  # node_id or None
        self.children = [None] * 8
        self.child_count = 0
        self.r = 0
        self.g = 0
        self.b = 0
        self.count = 0

    def sort_key(self):
        # octree.rs:221-238: child_count, then depth-weighted pixel count,
        # then node_id.
        return (self.child_count, self.count >> self.level, self.node_id)

    def output_color(self):
        # Integer-truncating division (octree.rs:131-138).
        return (self.r // self.count, self.g // self.count, self.b // self.count, 255)


class ColorTree:
    """Mirror of `ColorTree` (octree.rs:28-113)."""

    def __init__(self) -> None:
        self.nodes: list[_Node] = [_Node(0, None, 0, 0)]

    def add_color(self, r: int, g: int, b: int, weight: int = 1) -> None:
        """Descend 8 levels on the RGB bit-planes and accumulate at the leaf
        (octree.rs:42-65). `weight` aggregates identical pixels."""
        node_id = 0
        for level in range(MAX_DEPTH):
            mask = 0b10000000 >> level
            idx = (
                (0b100 if r & mask else 0)
                | (0b010 if g & mask else 0)
                | (0b001 if b & mask else 0)
            )
            node = self.nodes[node_id]
            child = node.children[idx]
            if child is None:
                child = len(self.nodes)
                # Child stores the *parent's* level (octree.rs:49-51: the
                # pre-increment `level` is passed to Node::with_parent).
                self.nodes.append(_Node(child, node_id, idx, level))
                node.children[idx] = child
                node.child_count += 1
            node_id = child
        leaf = self.nodes[node_id]
        leaf.r += r * weight
        leaf.g += g * weight
        leaf.b += b * weight
        leaf.count += weight

    def add_pixels(self, rgb: np.ndarray) -> None:
        """Aggregate an `[N, 3]` uint8 pixel array into the tree.

        Colors are inserted in FIRST-OCCURRENCE (scan) order: the merge
        queue's final tie-breaker is node_id (octree.rs:221-238), i.e.
        node-creation order, so insertion order is semantically relevant —
        scan order reproduces the reference's per-pixel loop exactly."""
        rgb = np.asarray(rgb, dtype=np.uint32)
        packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
        uniq, first_idx, counts = np.unique(
            packed, return_index=True, return_counts=True
        )
        order = np.argsort(first_idx, kind="stable")
        for value, count in zip(uniq[order].tolist(), counts[order].tolist()):
            self.add_color((value >> 16) & 0xFF, (value >> 8) & 0xFF, value & 0xFF, count)

    def reduce(self, color_count: int) -> list[tuple[int, int, int, int]]:
        """Merge least-important nodes until <= color_count remain
        (octree.rs:67-113)."""
        if color_count == 0:
            return []

        # Populated nodes sorted DESCENDING by sort_key (like the
        # reference's VecDeque) so the least-important node pops from the
        # back in O(1). bisect works on ascending sequences, so the keys
        # list stores component-negated tuples.
        def neg_key(node: _Node):
            a, b, c = node.sort_key()
            return (-a, -b, -c)

        queue = sorted(
            (n for n in self.nodes if n.count > 0), key=neg_key
        )
        keys = [neg_key(n) for n in queue]

        def remove_node(node: _Node) -> None:
            i = bisect.bisect_left(keys, neg_key(node))
            if i < len(keys) and queue[i] is node:
                del queue[i]
                del keys[i]

        def insert_node(node: _Node) -> None:
            key = neg_key(node)
            i = bisect.bisect_left(keys, key)
            queue.insert(i, node)
            keys.insert(i, key)

        while len(queue) > color_count:
            node = queue.pop()
            keys.pop()
            if node.parent is None:
                continue
            parent = self.nodes[node.parent]
            # Remove the parent (if queued) before its key changes
            # (octree.rs:88-90), mutate, then reinsert (octree.rs:99-101).
            remove_node(parent)
            parent.r += node.r
            parent.g += node.g
            parent.b += node.b
            parent.count += node.count
            parent.child_count -= 1
            parent.children[node.color_index] = None
            node.parent = None
            insert_node(parent)

        palette = sorted(set(n.output_color() for n in queue))
        return palette


def extract_palette_octree(
    rgb: np.ndarray, color_count: int
) -> list[tuple[int, int, int, int]]:
    """`operations::extract_palette_octree` (`core/src/operations.rs:90-97`):
    build the tree over all pixels, then reduce."""
    tree = ColorTree()
    tree.add_pixels(rgb)
    return tree.reduce(color_count)
