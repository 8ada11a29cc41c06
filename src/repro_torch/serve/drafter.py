"""The transformer drafter — the port of the transformer branch of
``repro.serve.drafter``: what the engine's speculative step and the
scheduler's paged admission need from a KV-cached draft model."""
from __future__ import annotations

import torch

from repro_torch.models.transformer import Transformer


def paged_slot_extend(model: Transformer, toks, cache, b: int,
                      start_pos: int, new_pos: int):
    """One prompt chunk toks (ck,) through a paged cache for slot ``b``
    (the target and attention drafters alike): the batch-1 sub-cache is the
    whole pool plus slot ``b``'s table row, so the writes land only in that
    slot's pages (in place).  ``new_pos`` (``min(start + ck, S0)``) drops
    the padded tail of the last chunk from ``pos``: its positions hold
    garbage k/v past ``pos``, which the position gate masks until decode
    overwrites them.  -> (logits (1, ck, V), cache)."""
    dev = cache["pos"].device
    sub = {"k": cache["k"], "v": cache["v"],
           "page_table": cache["page_table"][b:b + 1],
           "pos": torch.full((1,), start_pos, dtype=torch.int64, device=dev)}
    logits, _ = model.extend_step(toks[None], sub)
    pos = cache["pos"].clone()
    pos[b] = new_pos
    return logits, dict(cache, pos=pos)


class TransformerDrafter:
    """Position-gated KV cache: rollback is pos-only, nothing to
    checkpoint; the serving cache pages through the shared pool and paged
    admission streams the prompt in fixed chunks."""
    name = "transformer"
    state_keys = ()
    paged_cache = True
    chunked_extend = True

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

    def init_serve_cache(self, model: Transformer, batch: int, *,
                         max_seq: int, num_pages: int, page_size: int,
                         max_pages: int):
        """The drafter's zero serving cache for paged scheduling: an
        attention draft joins the page pool (``max_seq`` sizes only the
        dense state of recurrent drafts, which are not ported)."""
        del max_seq
        return model.init_paged_cache(batch, num_pages, page_size, max_pages)

    def slot_extend(self, model: Transformer, toks, cache, b: int,
                    start_pos: int, new_pos: int):
        """One admission chunk for slot ``b`` -> (logits (1, ck, V),
        cache)."""
        return paged_slot_extend(model, toks, cache, b, start_pos, new_pos)


def get_drafter(cfg) -> TransformerDrafter:
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"no drafter ported for arch_type={cfg.arch_type!r} (the "
            "recurrent and hybrid drafters are not ported)")
    return TransformerDrafter()
