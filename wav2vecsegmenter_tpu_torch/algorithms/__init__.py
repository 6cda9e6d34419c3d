"""Segmentation algorithms: frame probabilities -> sentence-like segments.

All functions consume the single stitched full-talk probability array and
run on the host: O(frames) NumPy, sequential and data-dependent (reference
lib/segment.py).  Copies of the JAX package's ``algorithms``: pDAC over
probabilities or, for the multi-class heads, with argmax trimming over the
frame logits (``pdac_with_logits``), pTHR and pSTRM; the tree variant
comes with the synthetic-data tool.
"""

from .pdac import pdac, pdac_with_logits
from .pthr import pthr
from .segment import Segment, argtrim, split_and_argtrim
from .strm import strm
from .yaml_out import update_yaml_content

__all__ = ["Segment", "argtrim", "split_and_argtrim", "pdac",
           "pdac_with_logits", "pthr", "strm", "update_yaml_content"]
