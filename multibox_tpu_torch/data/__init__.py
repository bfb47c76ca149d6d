"""Input side of the port: eval preprocessing and the host prefetcher."""
