"""Sharding rules for the production mesh (``rules``) and the explicit
SPMD layout that carries them out over ``torch.distributed``
(``spmd``)."""
from repro_torch.sharding.rules import (  # noqa: F401
    AbstractMesh,
    axis_sizes,
    batch_leading_specs,
    batch_spec,
    cache_specs,
    dp_axes,
    engine_state_specs,
    logits_spec,
    opt_state_specs,
    param_specs,
    spec_for_shape,
)
