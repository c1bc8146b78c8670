"""The LM substrate's serving path (every family): parameter templates,
layers, the MoE and Mamba2 blocks, the transformer forward and the
prefill / decode steps."""
