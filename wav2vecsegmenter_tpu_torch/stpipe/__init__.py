"""The ST-evaluation harness: segmentation yaml -> fairseq dataset ->
translation (an external ``fairseq-generate``) -> mWER realignment ->
scores.  Host code; copies of the JAX package's ``stpipe``."""
