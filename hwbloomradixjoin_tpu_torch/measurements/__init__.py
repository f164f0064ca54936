"""The sweep harness over the port's command line (counterpart of the
repository's measurements/ directory)."""
