"""Model modules: wav2vec 2.0 backbone, SFC head, SHAS."""
