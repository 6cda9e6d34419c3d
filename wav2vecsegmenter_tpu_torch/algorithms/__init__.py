"""Segmentation algorithms: frame probabilities -> sentence-like segments.

All functions consume the single stitched full-talk probability array and
run on the host: O(frames) NumPy, sequential and data-dependent (reference
lib/segment.py).  Copies of the JAX package's ``algorithms`` for the bce
head; the tree and logits variants come with the heads that use them.
"""

from .pdac import pdac
from .pthr import pthr
from .strm import strm
from .yaml_out import update_yaml_content

__all__ = ["pdac", "pthr", "strm", "update_yaml_content"]
