"""Port modules: layers, UNet, VAE, the CLIP towers, the FID InceptionV3,
StableDiffusion and the builders."""
