"""PyTorch/CUDA port of soft_intro_vae_tpu, slice by slice (see ROADMAP.md).

The JAX package ``soft_intro_vae_tpu`` stays the reference; this package
imports neither it nor JAX. Module names mirror the JAX package's. Entry
points run on CUDA unless the caller passes ``device="cpu"``; the hand-written
kernels under ``ops/csrc`` are compiled with ``nvcc`` on first CUDA use, never
at import.
"""
