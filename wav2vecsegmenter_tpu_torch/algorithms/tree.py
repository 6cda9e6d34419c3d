"""Binary segmentation tree (pDAC-tree) used by the synthetic-data pipeline.

Behavioral contract: /root/reference/lib/segment.py:305-386.  The tree is a
breadth-first array (children of node i at 2i+1 / 2i+2); empty placeholder
nodes keep the binary-heap layout.

The port's copy of ``wav2vecsegmenter_tpu/algorithms/tree.py``
(tests/test_torch_copies.py holds the two equal).
"""

from __future__ import annotations

import logging

import numpy as np

from .segment import Segment, soft_trim, split_and_softtrim

logger = logging.getLogger(__name__)


def _empty_node(start: float) -> Segment:
    return Segment(start, start, probs=np.empty([0]))


def pdac_tree(
    probs: np.ndarray,
    max_segment_length: float = 18,
    min_segment_length: float = 0.2,
    boundary_threshold: float = 0.5,
    trim_threshold: float = 0,
    tree_depth: int = 20,
) -> list[Segment]:
    """Breadth-first pDAC tree (reference lib/segment.py:305-386)."""
    root = soft_trim(
        Segment(0, len(probs), probs=probs), boundary_threshold, trim_threshold
    )
    tree = [root]
    cond = [True]

    if len(root.probs) == 0:
        logger.warning("No segments found")
        return tree

    layer = 0
    p = 2**layer - 1
    while any(cond):
        if layer >= tree_depth:
            break
        for j, curr in enumerate(tree[p:]):
            if cond[j]:
                split_idx = int(np.argsort(curr.probs)[0])
                if curr.probs[split_idx] == 1:
                    tree.append(_empty_node(curr.start))
                    tree.append(_empty_node(curr.start))
                else:
                    sgm_a, sgm_b = split_and_softtrim(
                        curr, split_idx, boundary_threshold, trim_threshold
                    )
                    tree.append(
                        sgm_a
                        if sgm_a.duration >= min_segment_length
                        else _empty_node(sgm_a.start)
                    )
                    tree.append(
                        sgm_b
                        if sgm_b.duration >= min_segment_length
                        else _empty_node(sgm_b.start)
                    )
            else:
                tree.append(_empty_node(curr.start))
                tree.append(_empty_node(curr.start))
        layer += 1
        p = 2**layer - 1
        cond = [sgm.duration >= min_segment_length for sgm in tree[p:]]

    return tree


def visualize_tree(tree: list[Segment], depth: int = 999) -> str:
    """Render tree layers as text (reference lib/segment.py:289-302)."""
    lines = []
    layer, nextp = 0, 1
    row = [f"layer({layer:03}): "]
    for i, seg in enumerate(tree):
        if i >= nextp:
            lines.append("".join(row))
            layer += 1
            nextp = 2 ** (layer + 1) - 1
            if layer > depth:
                break
            row = [f"layer({layer:03}): "]
        row.append(f"[{seg.offset}+{seg.duration}] ")
    else:
        lines.append("".join(row))
    return "\n".join(lines)
