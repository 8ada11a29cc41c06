"""Training loop of the port."""
