"""Eval metrics: the metric protocol and MeanSquaredError."""
