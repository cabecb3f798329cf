"""Tools of the port: the probe harness (`perf_probe`)."""
