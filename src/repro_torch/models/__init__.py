"""Dense transformer models of the port."""
