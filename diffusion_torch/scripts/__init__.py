"""The port's entry points: `python -m diffusion_torch.scripts.<name>`."""
