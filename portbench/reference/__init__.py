"""The plain reference: plain PyTorch in float32 (TF32 off on the card),
importing nothing of the program. `unet` is the model, `train` its loss,
gradient and AdamW, `lowp` the lower-precision control."""
