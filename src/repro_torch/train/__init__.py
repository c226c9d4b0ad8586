"""Training: the synthetic data stream, AdamW, checkpoints and the
fault-tolerant ``Trainer``."""
