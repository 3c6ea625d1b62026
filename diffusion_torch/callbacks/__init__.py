"""Trainer callbacks: the monitors the yamls declare."""
