"""Training on one device: the synthetic token stream, AdamW written from
scratch and step-atomic checkpoints, each the twin of the module of the same
name in the reference's ``repro/training/``."""
