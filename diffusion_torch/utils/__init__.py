"""Framework-free helpers: time units, loggers, the device default."""
