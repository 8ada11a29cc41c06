"""Training data of the port."""
