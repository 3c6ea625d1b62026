"""Trainer callbacks: the monitors the yamls declare, and the eval's
image logging (`LogDiffusionImages`)."""
