"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
``quickstart``, ``serve_watermarked`` and ``tradeoff_curves``."""
