"""Multi-process training: the process group, the device mesh, FSDP and
the token-sharded (sequence-parallel) UNet body."""
