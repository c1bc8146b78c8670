"""Kernel families of the pair pipeline, the long-read lane and the mesh
plans, and the three building blocks (`light_align`, `xxhash`,
`seed_gather`) that share device code with them, and the LM serving
path's `flash_attention`: each `<family>/ref.py` is
the plain PyTorch version, each `<family>/ops.py` the wrapper that
launches the hand-written CUDA kernel (sources under ``repro_torch/csrc``)
on CUDA tensors and uses the plain version on CPU tensors."""
