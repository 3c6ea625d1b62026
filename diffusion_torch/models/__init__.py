"""Port modules: layers, UNet, VAE decode, CLIP text, StableDiffusion."""
