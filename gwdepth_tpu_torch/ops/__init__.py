"""Tensor ops of the port: resizes, grid sampling, windows, position
embeddings, and the two kernel wrappers (`ref_attn_diffusion`,
`fused_conv`)."""
