"""Segmentation algorithms: frame probabilities -> sentence-like segments.

All functions consume the single stitched full-talk probability array and
run on the host: O(frames) NumPy, sequential and data-dependent (reference
lib/segment.py).  Copies of the JAX package's ``algorithms``: pDAC over
probabilities or, for the multi-class heads, with argmax trimming over the
frame logits (``pdac_with_logits``), pTHR, pSTRM, and the synthetic-data
tool's pDAC tree (``pdac_tree``).
"""

from .pdac import pdac, pdac_with_logits
from .pthr import pthr
from .segment import Segment, argtrim, split_and_argtrim
from .strm import strm
from .tree import pdac_tree, visualize_tree
from .yaml_out import update_tree_yaml_content, update_yaml_content

__all__ = ["Segment", "argtrim", "split_and_argtrim", "pdac",
           "pdac_with_logits", "pdac_tree", "visualize_tree", "pthr", "strm",
           "update_tree_yaml_content", "update_yaml_content"]
