"""The LM substrate's serving path (dense family): parameter templates,
layers, the transformer forward and the prefill / decode steps."""
