"""PyTorch + CUDA port of the watermarked speculative-sampling system.

The JAX package ``repro`` is the reference; this package never imports it
(nor ``jax``).  It mirrors ``repro``'s layout, so each module's counterpart
sits at the same relative path.  Entry points run on ``device="cuda"``
unless the caller asks for the CPU; on the CPU every kernel wrapper takes
its plain PyTorch version, on a CUDA tensor it launches the hand-written
Hopper kernel (``kernels/csrc``) or raises.
"""
