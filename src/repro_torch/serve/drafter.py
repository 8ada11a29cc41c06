"""The transformer drafter — the port of the transformer branch of
``repro.serve.drafter``: what the engine's speculative step needs from a
KV-cached draft model."""
from __future__ import annotations

from repro_torch.models.transformer import Transformer


class TransformerDrafter:
    """Position-gated KV cache: rollback is pos-only, nothing to
    checkpoint."""

    def prefill(self, model: Transformer, tokens, max_seq: int):
        return model.prefill(tokens, max_seq)

    def propose(self, model: Transformer, token, cache):
        """One draft decode step -> (logits (B, V), cache)."""
        return model.decode_step(token, cache)

    def checkpoint(self, cache):
        """KV drafters need no per-step snapshot."""
        return None

    def commit(self, model: Transformer, last_draft_tok, cache, checkpoints,
               pos0, out_len):
        """Re-feed the K-th draft token (propose consumed [last, d_1 ..
        d_{K-1}]), then roll the position back to the committed length."""
        del checkpoints
        _, cache = model.decode_step(last_draft_tok, cache)
        return dict(cache, pos=pos0 + out_len)


def get_drafter(cfg) -> TransformerDrafter:
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"no drafter ported for arch_type={cfg.arch_type!r}")
    return TransformerDrafter()
