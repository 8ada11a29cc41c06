"""Watermark decoders of the port (importing registers them)."""
from repro_torch.core.watermark import gumbel, synthid  # noqa: F401
from repro_torch.core.watermark.base import (Decoder, FusedTail, get_decoder,
                                             register)

__all__ = ["Decoder", "FusedTail", "get_decoder", "register"]
