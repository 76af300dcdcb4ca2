"""Operations of a whole model step, worked out from a configuration: the
numerators of the `mfu_pct.*` metrics.  One module a model family,
counting only the work the inputs need (real tokens, no padding)."""
