"""Optimizers (AdamW, Adafactor), the LR schedule and gradient codecs of
the training path."""
