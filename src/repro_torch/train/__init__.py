"""Training: synthetic data, AdamW, the train step, checkpoints and the
fault-tolerant loop (port of ``repro.train``)."""
