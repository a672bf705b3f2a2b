"""Training of the port's dense decoder models: AdamW, the synthetic
Markov data stream, checkpoints in the reference's format, and the
training loop."""
