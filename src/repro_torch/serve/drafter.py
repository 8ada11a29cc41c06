"""Drafters — the port of ``repro.serve.drafter``: what the engine's
speculative step and the scheduler's paged admission need from a draft
model, per family.

  1. ``prefill``     — build the draft cache from the prompt;
  2. ``propose``     — one draft decode step;
  3. ``checkpoint``  — snapshot the per-step state that rollback needs;
  4. ``commit``      — the K-th-token catch-up step, then the per-row
                       rollback to the accepted length;
  5. ``slot_extend`` — one batch-1 admission chunk of the paged scheduler.

Attention drafters keep a position-gated KV cache (rollback is pos-only,
nothing to checkpoint) and page it through the shared pool.  Recurrent
drafters (RWKV6 / Mamba2 backbones) carry O(1) state per slot with no
position gate: rollback selects per-step checkpoints, and the state lives
in dense (L, B, ...) rows outside the pool.  Hybrid (shared-attention)
drafters roll back the same way but serve in dense mode only: their
attention sites have no chunked extend.  ``get_drafter(cfg)`` picks the
family by ``arch_type``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.models.model import Model

# recurrent cache entries that need per-step checkpoints for rollback
# (position-gated k/v never roll back: pos-only commit suffices)
RECURRENT_KEYS = ("wkv", "att_shift", "ffn_shift", "conv", "ssm")


def rollback_checkpoints(cache, checkpoints: Optional[Dict[str, List]],
                         pos0, out_len):
    """Commit per row: ``pos`` advances to pos0 + out_len, and every
    recurrent state takes the checkpoint after ``out_len`` consumed tokens
    (``checkpoints[k][n]``: the (L, B, ...) state after n + 1 tokens; row b
    selects entry out_len[b] - 1 along the batch axis 1)."""
    cache = dict(cache, pos=pos0 + out_len)
    for k, chks in (checkpoints or {}).items():
        pick = out_len - 1
        sel = chks[0]
        for n in range(1, len(chks)):
            m = (pick == n).reshape((1, -1) + (1,) * (sel.dim() - 2))
            sel = torch.where(m, chks[n], sel)
        cache[k] = sel.to(cache[k].dtype)
    return cache


def paged_slot_extend(model: Model, toks, cache, b: Optional[int],
                      start_pos: int, new_pos: int, table=None):
    """One prompt chunk toks (ck,) through a paged cache for slot ``b``
    (the target and attention drafters alike): the batch-1 sub-cache is the
    whole pool plus slot ``b``'s table row, so the writes land only in that
    slot's pages (in place).  ``new_pos`` (``min(start + ck, S0)``) drops
    the padded tail of the last chunk from ``pos``: its positions hold
    garbage k/v past ``pos``, which the position gate masks until decode
    overwrites them.  ``b`` None is a rank of a sharded scheduler that
    holds no row of the slot: the chunk writes its copy of the pool
    through ``table`` (the slot's (1, max_pages) row), and no ``pos``
    moves.  -> (logits (1, ck, V), cache)."""
    dev = cache["pos"].device
    sub = {"k": cache["k"], "v": cache["v"],
           "page_table": table if b is None else cache["page_table"][b:b + 1],
           "pos": torch.full((1,), start_pos, dtype=torch.int64, device=dev)}
    logits, _ = model.extend_step(toks[None], sub)
    if b is None:
        return logits, cache
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

    def prefill(self, model: Model, tokens, max_seq: int):
        return model.prefill(tokens, max_seq)

    def propose(self, model: Model, token, cache):
        """One draft decode step -> (logits (B, V), cache)."""
        return model.decode_step(token, cache)

    def checkpoint(self, cache):
        """KV drafters need no per-step snapshot."""
        return None

    def commit(self, model: Model, last_draft_tok, cache, checkpoints,
               pos0, out_len):
        """Re-feed the K-th draft token (propose consumed [last, d_1 ..
        d_{K-1}], so one catch-up step gives the all-accepted path its full
        prefix), then roll the position back to the committed length."""
        del checkpoints
        _, cache = model.decode_step(last_draft_tok, cache)
        return dict(cache, pos=pos0 + out_len)

    def init_serve_cache(self, model: Model, batch: int, *, max_seq: int,
                         num_pages: int, page_size: int, max_pages: int):
        """The drafter's zero serving cache for paged scheduling: an
        attention draft joins the page pool."""
        del max_seq
        return model.init_paged_cache(batch, num_pages, page_size, max_pages)

    def slot_extend(self, model: Model, toks, cache, b: Optional[int],
                    start_pos: int, new_pos: int, table=None):
        """One admission chunk toks (ck,) for slot ``b`` through its pages
        (``b`` None: through ``table``, ``paged_slot_extend``) -> (logits
        (1, ck, V), cache)."""
        return paged_slot_extend(model, toks, cache, b, start_pos, new_pos,
                                 table)


class RecurrentDrafter(TransformerDrafter):
    """RWKV6 / Mamba2 backbones: per-step state checkpoints, dense state
    rows outside the pool, chunked admission through ``extend_step``."""
    name = "recurrent"
    state_keys = RECURRENT_KEYS
    paged_cache = False
    chunked_extend = True

    def checkpoint(self, cache):
        """The recurrent entries of the cache (references: every step makes
        new state tensors)."""
        return {k: cache[k] for k in self.state_keys if k in cache}

    def commit(self, model: Model, last_draft_tok, cache, checkpoints,
               pos0, out_len):
        """The catch-up step, then every row takes the checkpoint after its
        committed length (``pos`` moves as for a KV drafter)."""
        _, cache = model.decode_step(last_draft_tok, cache)
        steps = list(checkpoints) + [self.checkpoint(cache)]
        chks = {k: [c[k] for c in steps] for k in steps[0]}
        return rollback_checkpoints(cache, chks, pos0, out_len)

    def init_serve_cache(self, model: Model, batch: int, *, max_seq: int,
                         num_pages: int, page_size: int, max_pages: int):
        """Dense (L, B, ...) state rows outside the pool (``max_seq`` sizes
        the rows that hold k/v), with a per-slot ``pos``."""
        del num_pages, page_size, max_pages
        return model.init_cache(batch, max_seq)

    def slot_extend(self, model: Model, toks, cache, b: Optional[int],
                    start_pos: int, new_pos: int, table=None):
        """``extend_step`` on a batch-1 slice of the state rows with the
        padded tail identity-masked (``n_valid``); the rows are written
        back in place.  A re-admitted slot's rows still hold the previous
        request's state, which no position gate hides, so the first chunk
        (``start_pos == 0``) starts from zeros, as a solo prefill does.
        ``b`` None (a sharded scheduler's rank that holds no row of the
        slot) runs the chunk on zero rows, so that its weight gathers meet
        the holder's; ``table`` is unused (the state is not paged)."""
        del table
        keys = [k for k in self.state_keys if k in cache]
        rows = slice(0, 0) if b is None else slice(b, b + 1)
        sub = {k: (torch.zeros_like(cache[k][:, rows]) if start_pos == 0
                   else cache[k][:, rows]) for k in keys}
        sub["pos"] = torch.full((rows.stop - rows.start,), start_pos,
                                dtype=torch.int64, device=cache["pos"].device)
        logits, sub = model.extend_step(toks[None][:rows.stop - rows.start],
                                        sub, n_valid=new_pos - start_pos)
        if b is None:
            return logits, cache
        for k in keys:
            cache[k][:, b] = sub[k][:, 0].to(cache[k].dtype)
        pos = cache["pos"].clone()
        pos[b] = new_pos
        return logits, dict(cache, pos=pos)


class HybridDrafter(RecurrentDrafter):
    """Zamba2: recurrent state plus shared-attention k/v (position-gated,
    so rollback still selects only the recurrent checkpoints); no chunked
    extend for the attention sites, so dense-mode drafting only."""
    name = "hybrid"
    chunked_extend = False


_DRAFTERS = {**{fam: TransformerDrafter()
                for fam in ("dense", "moe", "vlm", "audio")},
             "ssm": RecurrentDrafter(), "hybrid": HybridDrafter()}


def get_drafter(cfg) -> TransformerDrafter:
    """The drafter of ``cfg.arch_type``; an unknown family raises (a
    defaulted drafter would commit with the wrong rollback)."""
    d = _DRAFTERS.get(cfg.arch_type)
    if d is None:
        raise ValueError(
            f"no drafter registered for arch_type={cfg.arch_type!r} "
            f"(registered: {sorted(_DRAFTERS)})")
    return d
