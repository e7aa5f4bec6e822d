"""Training: AdamW with fp32 master weights and the train step."""
