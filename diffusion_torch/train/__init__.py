"""Training: optimizer and schedules, state, events, the Trainer."""
