"""Speculative serving engine of the port."""
