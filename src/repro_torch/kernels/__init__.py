"""Hand-written Hopper kernels (csrc/), their plain versions (ref) and
the device dispatch (ops)."""
