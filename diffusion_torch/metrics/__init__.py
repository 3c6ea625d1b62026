"""Eval metrics: the metric protocol, MeanSquaredError, and the generation
metrics (FID, Inception Score, CLIPScore) with their towers and the
per-guidance-scale hook."""
