"""One module per kind of traffic, named by the traffic file's `kind`."""
