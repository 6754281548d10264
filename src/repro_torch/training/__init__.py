"""The training path: the trainer (loss, gradient accumulation, the clip,
the optimizer step), its optimizers (AdamW, Adafactor), checkpoints, and
the param-tree helpers they share."""
