"""Model forward and training loss of the port for the RoPE attention-only
families."""
