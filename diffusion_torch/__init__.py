"""diffusion_torch: the PyTorch/CUDA port of diffusion_tpu for NVIDIA Hopper.

It mirrors diffusion_tpu's layout (models/, ops/, schedulers/, inference/)
and imports torch, never jax.
"""
