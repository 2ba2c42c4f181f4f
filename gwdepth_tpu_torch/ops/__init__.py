"""Tensor ops of the port: resizes, grid sampling, windows, position
embeddings, the host Hungarian matcher (`lap`), and the two kernel
wrappers (`ref_attn_diffusion`, `fused_conv`)."""
