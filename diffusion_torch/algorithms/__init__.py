"""Training algorithms (EMA)."""
