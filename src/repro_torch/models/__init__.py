"""Model forward of the port for the RoPE attention-only families."""
