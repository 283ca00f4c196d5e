"""Training of the attention family on one device: AdamW, the synthetic
data stream, the train step and checkpoints."""
