"""Batched speculative decoding with watermarking (Algorithm 1) — the port
of ``repro.serve.engine`` on one device.

One spec step: K watermarked draft samples from the draft model, one
target ``extend_step`` over the K+1 fed tokens, the ζ^R acceptance coins,
the fused verification tail (``kernels.ops.spec_verify_wm``) or the
decoder-generic tail (``fused="off"``), and the per-row commit.  Every
token the step samples goes through the decoder's batched
``draft_sampler`` or the fused tail, i.e. through a kernel on the card.

``make_gen_loop`` runs spec steps on the host over a carry of output
buffers (``init_gen_carry``) and reads the ``done`` flags once per step
(one device-to-host sync per spec step); a step in which no slot is live
never runs, so ``n_steps`` equals the reference's.  ``generate`` runs one
loop over a prefilled batch; ``serve_requests`` (and its async-iterator
form ``serve_stream``) runs it in rounds under the continuous-batching
``serve.scheduler.Scheduler``.  The KV caches are
written in place, so a resumed ``state`` is consumed.

Sharded execution (``mesh=``, a ``DeviceMesh`` over the ranks of a
``torch.distributed`` group, every rank calling with the same
arguments): the models are sharded in place by the production rules
(``sharding.spmd.shard_params``; ``shard_params=False`` leaves them
whole on every rank), and the batch splits over the mesh's dp axes
(``sharding.rules.dp_axes``; a batch that does not divide replicates):
each rank holds the engine state, caches and output buffers of its own
rows.  The loop's done test is one all-reduce a step, so every rank runs
the same steps, and the result is gathered to every rank; the returned
``state`` holds this rank's rows and resumes with the same mesh.

Drafts and targets may be recurrent (``models.ssm.RecurrentLM``): the
drafter (``serve.drafter``) checkpoints and rolls back a recurrent draft,
and a recurrent target runs its K+1 fed tokens one decode step at a time
with state checkpoints (``_run_target``).  Recurrent state has no position
gate, so the ``live`` freeze restores a frozen slot's state rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import prf
from repro_torch.core import watermark as _wm  # noqa: F401  (registers)
from repro_torch.core.watermark.base import (Decoder, FusedTail, get_decoder,
                                             race_draft_sampler)
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels import ref
from repro_torch.models.model import Model, is_recurrent
from repro_torch.serve.drafter import (RECURRENT_KEYS, get_drafter,
                                       rollback_checkpoints)
from repro_torch.sharding import spmd

EPS = 1e-30


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    K: int = 4                   # lookahead
    ctx_window: int = 4          # context-hash window c
    temperature: float = 1.0
    watermark: str = "gumbel"    # gumbel | synthid | synthid-inf | none
    m: int = 30                  # synthid tournament rounds
    accept: str = "pseudorandom"  # pseudorandom (Alg. 1) | standard
    mask_repeated: bool = True
    history_cap: int = 1024      # repeated-context history buffer size
    fused: str = "auto"          # auto | on | off — fused verification tail


def use_fused(scfg: SpecConfig) -> bool:
    """The fused tail runs for every scheme whose decoder declares one;
    ``fused="on"`` raises for a scheme that declares none."""
    if scfg.fused == "off":
        return False
    dec = make_decoder(scfg)
    fusable = dec.fused_tail is not None
    if scfg.fused == "on" and not fusable:
        raise ValueError(
            f"fused='on' unsupported for watermark={scfg.watermark!r}: "
            f"decoder {dec.name!r} registers no fused verification tail")
    return fusable


def _plain_decoder(m: int = 30, **kw) -> Decoder:
    """No watermark: categorical sampling as a Gumbel race on offset plain
    streams (non-recoverable randomness)."""
    def sample(probs, key, ctx_hash, stream=0):
        seed = prf.wm_seed(key, ctx_hash, prf.STREAM_PLAIN + stream + 13)
        return ref.gumbel_argmax_ref(probs[None], seed[None])[0][0], \
            torch.zeros(())

    return Decoder(name="none", sample=sample, stat_dim=1, degenerate=False,
                   draft_stream=prf.STREAM_PLAIN + prf.STREAM_DRAFT + 13,
                   target_stream=prf.STREAM_PLAIN + prf.STREAM_TARGET + 13,
                   token_stat=None,
                   fused_tail=FusedTail(kind="race", stat_dim=1),
                   draft_sampler=race_draft_sampler)


def make_decoder(scfg: SpecConfig) -> Decoder:
    if scfg.watermark == "none":
        return _plain_decoder(m=scfg.m)
    return get_decoder(scfg.watermark, m=scfg.m)


def _token_stat_batch(dec: Decoder, seeds, tokens, vocab: int):
    """Detection statistics of tokens (...,) under seeds (...,) ->
    (..., stat_dim); zeros for schemes without a recoverable statistic."""
    if dec.token_stat is None:
        return torch.zeros(tokens.shape + (dec.stat_dim,),
                           dtype=torch.float32, device=tokens.device)
    return dec.token_stat(seeds, tokens, vocab)


def strength_gate(keys, ctx_h, strength):
    """True where the position's STREAM_GAMMA coin is >= the slot's
    strength, i.e. the position is sampled unwatermarked."""
    return prf.uniform_from(keys, ctx_h, prf.STREAM_GAMMA) >= strength


def _strength_vec(strength, B: int, device) -> torch.Tensor:
    if strength is None:
        return torch.ones(B, dtype=torch.float32, device=device)
    s = torch.as_tensor(strength, dtype=torch.float32, device=device)
    return s.expand(B).clone() if s.ndim == 0 else s


def _sample(dec: Decoder, probs, keys, ctx_h, seen, wm_stream: int,
            plain_stream: int):
    """Every sampled token of the path: the scheme's batched sampler."""
    return dec.draft_sampler(probs, keys, ctx_h, seen, wm_stream=wm_stream,
                             plain_stream=plain_stream)


def first_token_meta(dec: Decoder, scfg: SpecConfig, keys, last_logits,
                     window, vocab: int, strength) -> Dict[str, Any]:
    """Sample the first token from the prefill's last logits (B, V) under
    the context ``window`` (B, c), with its slot-0 metadata."""
    ctx0 = prf.context_hash(window)
    gate = strength_gate(keys, ctx0, strength)
    p0 = torch.softmax(last_logits.float() / scfg.temperature, dim=-1)
    first = _sample(dec, p0, keys, ctx0, gate, dec.target_stream,
                    prf.STREAM_PLAIN + 3)
    return {
        "window": torch.cat([window[:, 1:], first[:, None]], dim=1),
        "last": first,
        "last_ctx": ctx0,
        "last_u": prf.accept_uniform(keys, ctx0),
        "last_msk": gate,
        "last_yd": _token_stat_batch(
            dec, prf.wm_seed(keys, ctx0, prf.STREAM_DRAFT), first, vocab),
        "last_yt": _token_stat_batch(
            dec, prf.wm_seed(keys, ctx0, prf.STREAM_TARGET), first, vocab),
    }


def prompt_window(prompts, c: int):
    """The last ``c`` prompt tokens, left-padded with zeros."""
    window = prompts[:, -c:]
    if window.shape[1] < c:
        window = torch.nn.functional.pad(window, (c - window.shape[1], 0))
    return window


def init_state(t_model: Model, d_model: Model, scfg: SpecConfig,
               prompts: torch.Tensor, max_seq: int, key,
               strength=None, extras: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """Prefill both models on prompts (B, S0) and sample the first token.
    ``key`` is one key word or a (B,) row; ``strength`` None, a scalar or
    (B,).  ``extras`` carries the stub frontends' modality inputs
    ("image_emb" / "audio_emb") to the target's prefill only: the draft
    is a text-only LM."""
    B, S0 = prompts.shape
    dev = prompts.device
    dec = make_decoder(scfg)
    keys = prf.as_key_words(key, B, device=dev)
    sv = _strength_vec(strength, B, dev)
    t_logits, t_cache = (
        t_model.prefill(prompts, max_seq, extras={
            k: torch.as_tensor(v, device=dev)
            for k, v in extras.items()})
        if extras else t_model.prefill(prompts, max_seq))
    _, d_cache = get_drafter(d_model.cfg).prefill(d_model, prompts, max_seq)
    meta = first_token_meta(dec, scfg, keys, t_logits[:, -1],
                            prompt_window(prompts, scfg.ctx_window),
                            t_model.cfg.vocab, sv)
    gated0 = meta["last_msk"]
    hist = torch.zeros((B, scfg.history_cap), dtype=torch.int64, device=dev)
    hist[:, 0] = torch.where(gated0, 0, meta["last_ctx"])
    return {"t_cache": t_cache, "d_cache": d_cache, **meta,
            "keys": keys, "strength": sv,
            "n_committed": torch.full((B,), S0 + 1, dtype=torch.int64,
                                      device=dev),
            "hist": hist, "hist_n": (~gated0).to(torch.int64),
            "step_idx": 0}


def init_empty_paged_state(t_model: Model, d_model: Model,
                           scfg: SpecConfig, batch: int, *, num_pages: int,
                           page_size: int, max_pages: int,
                           max_seq: Optional[int] = None) -> Dict[str, Any]:
    """A zero engine state over block-paged KV pools, before any prefill:
    every slot has an all-null page table and pos 0, so a frozen slot's
    writes land in the null page and the position gate hides them.  The
    scheduler's chunked admission fills slots in place, and its finalize
    samples the first token as ``init_state`` does.  The target cache
    always pages; the draft cache follows its drafter: an attention draft
    joins the pool, a recurrent draft keeps dense state rows outside it
    (sized by ``max_seq``, by default the pool's logical extent
    ``max_pages * page_size``).  A recurrent target raises."""
    if is_recurrent(t_model.cfg):
        raise ValueError(
            f"paged serving needs an attention *target*: arch_type="
            f"{t_model.cfg.arch_type!r} is recurrent (no KV to page).  "
            "Recurrent models are first-class *drafters* — their O(1) "
            "state lives outside the paged pool (serve.drafter) — pass one "
            "as the draft model.")
    dec = make_decoder(scfg)
    dev = t_model.embed.device
    B, S = batch, dec.stat_dim
    t_cache = t_model.init_paged_cache(B, num_pages, page_size, max_pages)
    d_cache = get_drafter(d_model.cfg).init_serve_cache(
        d_model, B, max_seq=max_seq or max_pages * page_size,
        num_pages=num_pages, page_size=page_size, max_pages=max_pages)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "t_cache": t_cache, "d_cache": d_cache,
        "window": zeros((B, scfg.ctx_window), torch.int64),
        "last": zeros((B,), torch.int64),
        "last_ctx": zeros((B,), torch.int64),
        "last_u": zeros((B,), torch.float32),
        "last_msk": zeros((B,), torch.bool),
        "last_yd": zeros((B, S), torch.float32),
        "last_yt": zeros((B, S), torch.float32),
        "keys": zeros((B,), torch.int64),
        "strength": torch.ones(B, dtype=torch.float32, device=dev),
        "n_committed": zeros((B,), torch.int64),
        "hist": zeros((B, scfg.history_cap), torch.int64),
        "hist_n": zeros((B,), torch.int64),
        "step_idx": 0,
    }


class StepOutput(NamedTuple):
    out_tokens: torch.Tensor   # (B, K+1), zero past out_len
    out_len: torch.Tensor      # (B,) in [1, K+1]
    n_accepted: torch.Tensor   # (B,) in [0, K]
    from_draft: torch.Tensor   # (B, K+1) bool
    u: torch.Tensor            # (B, K) acceptance coins
    ctx_hashes: torch.Tensor   # (B, K+1) words
    masked: torch.Tensor       # (B, K+1) bool
    y_draft: torch.Tensor      # (B, K+1, stat_dim)
    y_target: torch.Tensor     # (B, K+1, stat_dim)


def _seen_in_history(hist, hist_n, ctx_h):
    valid = torch.arange(hist.shape[1], device=hist.device)[None] \
        < hist_n[:, None]
    return ((hist == ctx_h[:, None]) & valid).any(dim=-1)


def _standard_coins(keys, step_idx: int, K: int):
    """Fresh coins per row from a torch.Generator seeded by the row's key
    word and the step index (the reference's jax.random coins cannot be
    reproduced; this mode is held by acceptance rate)."""
    dev = keys.device
    rows = []
    for kw in keys.tolist():
        g = torch.Generator(device=dev).manual_seed((kw << 32) | step_idx)
        rows.append(torch.rand(K, generator=g, device=dev))
    return torch.stack(rows)


def _run_target(t_model: Model, fed, t_cache):
    """Run the K+1 fed tokens (B, K+1) through the target -> (logits (B,
    K+1, V), cache, checkpoints).  An attention target runs one batched
    ``extend_step`` (checkpoints None); a recurrent one decodes the tokens
    one at a time, keeping its state after each ({key: [K+1 states]})."""
    if not is_recurrent(t_model.cfg):
        logits, cache = t_model.extend_step(fed, t_cache)
        return logits, cache, None
    cache, logits = t_cache, []
    chks = {k: [] for k in RECURRENT_KEYS if k in t_cache}
    for i in range(fed.shape[1]):
        lg, cache = t_model.decode_step(fed[:, i], cache)
        logits.append(lg)
        for k, seq in chks.items():
            seq.append(cache[k])
    return torch.stack(logits, 1), cache, chks


def make_spec_step(tcfg, dcfg, scfg: SpecConfig) -> Callable:
    """Build step(t_model, d_model, state, live=None, eos_id=None) ->
    (state, StepOutput).  ``live`` (B,) bool freezes the slots that are
    False (their state rows, recurrent cache rows included, are carried
    unchanged); ``eos_id`` truncates the emission, and all committed
    state, at the first EOS."""
    dec = make_decoder(scfg)
    K, c, temp = scfg.K, scfg.ctx_window, scfg.temperature
    fused = use_fused(scfg)
    tail_wm_stream = dec.target_stream
    draft_wm_stream = dec.draft_stream
    tail_streams = (tail_wm_stream, prf.STREAM_PLAIN + 2,
                    prf.STREAM_PLAIN + 3, prf.STREAM_PLAIN + tail_wm_stream)
    drafter = get_drafter(dcfg)

    def seen_of(state, keys, ctx_h):
        B = ctx_h.shape[0]
        seen = (_seen_in_history(state["hist"], state["hist_n"], ctx_h)
                if scfg.mask_repeated
                else torch.zeros(B, dtype=torch.bool, device=ctx_h.device))
        return seen | strength_gate(keys, ctx_h, state["strength"])

    @torch.no_grad()
    def step(t_model, d_model, state, live=None, eos_id=None):
        t_cache, d_cache = state["t_cache"], state["d_cache"]
        window, last = state["window"], state["last"]
        hist, hist_n, keys = state["hist"], state["hist_n"], state["keys"]
        B = last.shape[0]
        dev = last.device
        t_pos0, d_pos0 = t_cache["pos"], d_cache["pos"]
        ar = torch.arange(K + 1, device=dev)[None]

        # ---- 1. draft K tokens ------------------------------------------
        cur, win = last, window
        draft_toks, q_fulls, ctx_hs, seens, d_chks = [], [], [], [], []
        for _ in range(K):
            logits, d_cache = drafter.propose(d_model, cur, d_cache)
            q = torch.softmax(logits.float() / temp, dim=-1)
            ctx_h = prf.context_hash(win)
            seen = seen_of(state, keys, ctx_h)
            cur = _sample(dec, q, keys, ctx_h, seen, draft_wm_stream,
                          prf.STREAM_PLAIN + 1)
            win = torch.cat([win[:, 1:], cur[:, None]], dim=1)
            d_chks.append(drafter.checkpoint(d_cache))
            draft_toks.append(cur)
            q_fulls.append(q)
            ctx_hs.append(ctx_h)
            seens.append(seen)
        draft_toks = torch.stack(draft_toks, 1)          # (B, K)
        q_fulls = torch.stack(q_fulls, 1)                # (B, K, V)
        ctx_hs = torch.stack(ctx_hs, 1)
        seens = torch.stack(seens, 1)
        ctx_bonus = prf.context_hash(win)
        seen_bonus = seen_of(state, keys, ctx_bonus)

        # ---- 2. target verification -------------------------------------
        fed = torch.cat([last[:, None], draft_toks], dim=1)
        t_logits, t_cache, t_chks = _run_target(t_model, fed, t_cache)
        p_fulls = torch.softmax(t_logits.float() / temp, dim=-1)
        V = p_fulls.shape[-1]

        # ---- 3. acceptance coins ----------------------------------------
        if scfg.accept == "pseudorandom":
            u = prf.accept_uniform(keys[:, None], ctx_hs)
        else:
            u = _standard_coins(keys, state["step_idx"], K)
        all_hashes = torch.cat([ctx_hs, ctx_bonus[:, None]], dim=1)
        all_seen = torch.cat([seens, seen_bonus[:, None]], dim=1)

        # ---- 4. verification tail ---------------------------------------
        if fused:
            n_acc, prefix_i, extra, _ = KOPS.spec_verify_wm(
                p_fulls, q_fulls, draft_toks, u, keys, all_hashes, all_seen,
                live, streams=tail_streams, tail=dec.fused_tail)
            prefix = prefix_i.bool()
        else:
            pt = p_fulls[:, :K].gather(-1, draft_toks[..., None])[..., 0]
            qt = q_fulls.gather(-1, draft_toks[..., None])[..., 0]
            a = torch.clamp_max(pt / torch.clamp_min(qt, EPS), 1.0)
            prefix = torch.cumprod((u < a).to(torch.int64), -1).bool()
            n_acc = prefix.sum(-1)
            resid = torch.clamp_min(p_fulls[:, :K] - q_fulls, 0.0)
            resid_toks = _sample(
                dec, resid.reshape(B * K, V), keys.repeat_interleave(K),
                ctx_hs.reshape(-1), seens.reshape(-1), tail_wm_stream,
                prf.STREAM_PLAIN + 2).reshape(B, K)
            bonus_tok = _sample(dec, p_fulls[:, K], keys, ctx_bonus,
                                seen_bonus, tail_wm_stream,
                                prf.STREAM_PLAIN + 3)
            extra = torch.where(
                n_acc == K, bonus_tok,
                resid_toks.gather(1, torch.clamp_max(n_acc, K - 1)[:, None])
                [:, 0])

        # ---- 5. outputs ---------------------------------------------------
        rows = torch.arange(B, device=dev)
        out = torch.zeros((B, K + 1), dtype=torch.int64, device=dev)
        out[:, :K] = torch.where(prefix, draft_toks, 0)
        out[rows, n_acc] = extra
        out_len = n_acc + 1
        if eos_id is not None:
            is_eos = (out == eos_id) & (ar < out_len[:, None])
            first = torch.where(is_eos.any(1),
                                torch.argmax(is_eos.to(torch.int64), 1),
                                K + 1)
            out_len = torch.minimum(out_len, first + 1)
            n_acc = torch.minimum(n_acc, out_len)
            out = torch.where(ar < out_len[:, None], out, 0)
        from_draft = ar < n_acc[:, None]
        y_d = _token_stat_batch(
            dec, prf.wm_seed(keys[:, None], all_hashes, prf.STREAM_DRAFT),
            out, V)
        y_t = _token_stat_batch(
            dec, prf.wm_seed(keys[:, None], all_hashes, prf.STREAM_TARGET),
            out, V)

        # ---- 6. commit ----------------------------------------------------
        t_cache = rollback_checkpoints(t_cache, t_chks, t_pos0, out_len)
        d_cache = drafter.commit(d_model, draft_toks[:, K - 1], d_cache,
                                 d_chks, d_pos0, out_len)
        full = torch.cat([window, out], dim=1)
        new_window = full.gather(
            1, out_len[:, None] + torch.arange(c, device=dev)[None])
        last_i = (out_len - 1)[:, None]
        u_rec = torch.cat([u, torch.zeros((B, 1), device=dev)], dim=1)
        new_state = dict(
            state, t_cache=t_cache, d_cache=d_cache, window=new_window,
            last=out.gather(1, last_i)[:, 0],
            last_ctx=all_hashes.gather(1, last_i)[:, 0],
            last_u=u_rec.gather(1, last_i)[:, 0],
            last_msk=all_seen.gather(1, last_i)[:, 0],
            last_yd=y_d[rows, out_len - 1], last_yt=y_t[rows, out_len - 1],
            n_committed=state["n_committed"] + out_len,
            step_idx=state["step_idx"] + 1)
        if scfg.mask_repeated:
            # slot s of an emitted, unseen context lands at (hist_n +
            # #adds before s) mod H; skipped slots go to a trash column
            add = (ar < out_len[:, None]) & ~all_seen
            H = hist.shape[1]
            add_i = add.to(torch.int64)
            off = torch.cumsum(add_i, 1) - add_i
            pos = torch.where(add, (hist_n[:, None] + off) % H, H)
            padded = torch.cat(
                [hist, torch.zeros((B, 1), dtype=hist.dtype, device=dev)], 1)
            padded[rows[:, None], pos] = torch.where(add, all_hashes, 0)
            new_state["hist"] = padded[:, :H]
            new_state["hist_n"] = hist_n + add_i.sum(1)
        if live is not None:
            # frozen slots keep their rows; KV entries written past a
            # frozen pos are overwritten before any read (position gate),
            # but recurrent state has no position gate, so its (L, B, ...)
            # rows revert (the step made new state tensors)
            dead = ~live
            for k in ("window", "last", "last_ctx", "last_u", "last_msk",
                      "last_yd", "last_yt", "n_committed", "hist", "hist_n"):
                d = dead.reshape((-1,) + (1,) * (new_state[k].ndim - 1))
                new_state[k] = torch.where(d, state[k], new_state[k])
            for cn in ("t_cache", "d_cache"):
                old, cache = state[cn], dict(new_state[cn])
                cache["pos"] = torch.where(dead, old["pos"], cache["pos"])
                for rk in RECURRENT_KEYS:
                    if rk in cache:
                        d = dead.reshape((1, -1) + (1,) * (cache[rk].ndim - 2))
                        cache[rk] = torch.where(d, old[rk], cache[rk])
                new_state[cn] = cache
        return new_state, StepOutput(
            out_tokens=out, out_len=out_len, n_accepted=n_acc,
            from_draft=from_draft, u=u, ctx_hashes=all_hashes,
            masked=all_seen, y_draft=y_d, y_target=y_t)

    return step


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, N) int32 committed tokens
    lengths: np.ndarray         # (B,) valid lengths
    from_draft: np.ndarray      # (B, N) int8, 1 = accepted draft token
    u: np.ndarray               # (B, N) coins of the emitted slots
    ctx_hashes: np.ndarray      # (B, N) uint32
    masked: np.ndarray          # (B, N) bool
    aatps: float                # accepted draft tokens per alive slot-step
    tokens_per_step: float      # delivered tokens per alive slot-step
    n_steps: int
    state: Optional[Dict[str, Any]] = None   # final engine state (resume)
    eos: Optional[np.ndarray] = None
    y_draft: Optional[np.ndarray] = None     # (B, N, stat_dim) under ζ^D
    y_target: Optional[np.ndarray] = None    # (B, N, stat_dim) under ζ^T
    stat_scheme: Optional[str] = None
    keys: Optional[np.ndarray] = None        # (B,) uint32 key words
    strength: Optional[np.ndarray] = None    # (B,) f32
    n_syncs: int = 0                         # device-to-host syncs


def _n_tokens_vec(n_tokens, B: int) -> np.ndarray:
    n_vec = np.asarray(n_tokens, np.int64)
    if n_vec.ndim == 0:
        n_vec = np.full((B,), int(n_vec), np.int64)
    if n_vec.shape != (B,):
        raise ValueError(f"n_tokens must be a scalar or length-{B} "
                         f"sequence, got shape {n_vec.shape}")
    if n_vec.min() < 1:
        raise ValueError(f"n_tokens targets must be >= 1, got {n_vec}")
    return n_vec


def _fit_caches(state, need: int):
    """Grow the KV caches of a resumed state to ``need`` positions along
    their sequence axis 2 (dense (L, B, S, Hkv, hd), a VLM's flat self
    layers and the hybrid's (n_sites, B, S, Hkv, hd) alike), so the
    continuation's writes stay in bounds (the reference would drop them).
    Only k/v grow: recurrent state and the fixed-extent cross memories
    (xk/xv, ck/cv) keep their shapes."""
    for cn in ("t_cache", "d_cache"):
        cache = state[cn]
        if "k" not in cache:
            continue
        S = cache["k"].shape[2]
        if S < need:
            pad = list(cache["k"].shape)
            pad[2] = need - S
            z = cache["k"].new_zeros(pad)
            state[cn] = dict(cache, k=torch.cat([cache["k"], z], 2),
                             v=torch.cat([cache["v"], z], 2))


def init_gen_carry(state: Dict[str, Any], n_vec, cap: int,
                   eos_id: Optional[int]) -> Dict[str, Any]:
    """The generation loop's carry over a prepared engine state: output
    buffers (B, cap + 1) whose slot 0 holds the pending committed token
    (the prefill sample, or the previous call's last token on resume) and
    whose last column takes clipped writes, per-slot flags and counters,
    and the host counts ``n_steps`` and ``n_syncs``.  A slot whose target
    the pending token already meets, or whose pending token is EOS, starts
    done."""
    last = state["last"]
    B, dev = last.shape[0], last.device
    S = state["last_yd"].shape[-1]

    def buf(first, dtype, extra=()):
        b = torch.zeros((B, cap + 1) + extra, dtype=dtype, device=dev)
        b[:, 0] = first
        return b

    eos0 = last == (-1 if eos_id is None else int(eos_id))
    n_tok = torch.as_tensor(np.asarray(n_vec), dtype=torch.int64, device=dev)
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    return {
        "state": state,
        "toks": buf(last, torch.int64),
        "fd": buf(0, torch.int8),            # slot 0 is never a draft
        "us": buf(state["last_u"], torch.float32),
        "chs": buf(state["last_ctx"], torch.int64),
        "msk": buf(state["last_msk"], torch.bool),
        "yd": buf(state["last_yd"], torch.float32, (S,)),
        "yt": buf(state["last_yt"], torch.float32, (S,)),
        "lens": torch.ones(B, dtype=torch.int64, device=dev),
        "eos": eos0,
        "done": eos0 | (n_tok <= 1),
        "total": zeros, "acc_total": zeros.clone(),
        "alive_steps": zeros.clone(),
        "n_steps": 0, "n_syncs": 0,
    }


def make_gen_loop(tcfg, dcfg, scfg: SpecConfig,
                  layout: Optional[spmd.Layout] = None,
                  dp: tuple = ()) -> Callable:
    """Build loop(t_model, d_model, carry, n_tokens, eos_id, step_limit)
    -> carry: run spec steps until every slot is done or the carry's
    ``n_steps`` reaches ``step_limit``, committing each step's outputs
    into the carry's buffers (in place).  Stopping is per slot: slot b is
    done once ``lens[b] >= n_tokens[b]`` (a (B,) tensor) or it emits
    ``eos_id``; a done slot is frozen (the step's ``live`` mask) and stops
    counting toward the AATPS denominators.  The loop reads the done flags
    on the host once per step (``n_syncs``); a step in which no slot is
    live never runs.  Each buffer's last column takes the clipped writes
    (a valid emission past ``cap``).  Over a sharded batch (``layout``,
    the carry this rank's rows of one split over ``dp``) the done test is
    global, one all-reduce a step: a rank whose rows are all done steps
    on, frozen, while another's are live."""
    step = make_spec_step(tcfg, dcfg, scfg)
    K1 = scfg.K + 1

    def loop(t_model, d_model, carry, n_tokens, eos_id, step_limit: int):
        c = dict(carry)
        cap = c["toks"].shape[1] - 1
        B, dev = c["lens"].shape[0], c["lens"].device
        eos_val = -1 if eos_id is None else int(eos_id)
        rows = torch.arange(B, device=dev)[:, None]
        idx = torch.arange(K1, device=dev)[None]
        while c["n_steps"] < step_limit:
            c["n_syncs"] += 1
            done = bool(c["done"].all())
            if layout is not None:
                done = layout.all_true(done, dp)
            if done:
                break
            live = ~c["done"]
            c["state"], outp = step(t_model, d_model, c["state"], live=live,
                                    eos_id=eos_id)
            pos = c["lens"][:, None] + idx
            emitted = (idx < outp.out_len[:, None]) & live[:, None]
            is_eos = emitted & (outp.out_tokens == eos_val)
            valid = emitted & (pos < cap)
            pos = torch.where(valid, pos, cap)
            o_u = torch.cat([outp.u, torch.zeros((B, 1), device=dev)], 1)
            for name, vals in (("toks", outp.out_tokens),
                               ("fd", outp.from_draft.to(torch.int8)),
                               ("us", o_u), ("chs", outp.ctx_hashes),
                               ("msk", outp.masked), ("yd", outp.y_draft),
                               ("yt", outp.y_target)):
                b = c[name]
                v = valid[..., None] if vals.ndim == 3 else valid
                b[rows, pos] = torch.where(v, vals, 0).to(b.dtype)
            c["lens"] = c["lens"] + valid.sum(1)
            c["eos"] = c["eos"] | is_eos.any(1)
            alive = live.to(torch.int64)
            c["done"] = c["done"] | c["eos"] | (c["lens"] >= n_tokens)
            c["total"] = c["total"] + outp.out_len * alive
            c["acc_total"] = c["acc_total"] + outp.n_accepted * alive
            c["alive_steps"] = c["alive_steps"] + alive
            c["n_steps"] += 1
        return c

    return loop


def shard(t_model: Model, d_model: Model, mesh, global_batch: int,
          shard_params: bool = True) -> spmd.Layout:
    """The mesh's layout for a batch of ``global_batch`` rows over the two
    models: shards their parameters in place (``shard_params``) and
    refuses a MoE model under a split batch."""
    layout = spmd.Layout(mesh)
    if shard_params:
        for m in (t_model, d_model):
            spmd.shard_params(m, mesh)
    spmd.refuse_moe_dp((t_model, d_model), layout, global_batch)
    return layout


def generate(t_model: Model, d_model: Model, scfg: SpecConfig,
             prompts, *, n_tokens, key, strength=None,
             sync_every: Optional[int] = None,
             state: Optional[Dict[str, Any]] = None,
             eos_id: Optional[int] = None,
             extras: Optional[Dict[str, Any]] = None,
             mesh=None, shard_params: bool = True) -> GenerationResult:
    """Run spec steps until every slot reaches its target (scalar or (B,)
    ``n_tokens``) or emits ``eos_id``; finished slots freeze while the
    others continue.  Pass ``state=`` (a previous result's ``.state``) to
    continue where that call stopped.  Runs on the models' device.
    ``extras`` ("image_emb" / "audio_emb", (B, frames, d)) feed a VLM or
    audio target's prefill.  ``mesh`` runs it sharded (module docstring):
    every rank passes the whole batch and gets the whole result.

    ``sync_every`` is accepted for parity with the reference and checked;
    the loop reads the done flags after every step either way."""
    if sync_every is not None and sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    dev = t_model.embed.device
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                              device=dev)
    B, S0 = prompts.shape
    n_vec = _n_tokens_vec(n_tokens, B)
    max_steps = int(n_vec.max())
    K1 = scfg.K + 1
    layout, dp, rows = None, (), slice(0, B)
    if mesh is not None:
        layout = shard(t_model, d_model, mesh, B, shard_params)
        dp, rows = layout.dp(B), layout.rows(B)
    if state is None:
        # worst case: a fast slot commits K+1 tokens on every step
        state = init_state(
            t_model, d_model, scfg, prompts[rows], S0 + 1 + K1 * max_steps
            + 2, prf.as_key_words(key, B, device=dev)[rows],
            strength=_strength_vec(strength, B, dev)[rows],
            extras=extras and {k: torch.as_tensor(v)[rows]
                               for k, v in extras.items()})
    else:
        state = dict(state)
        if state["last"].shape[0] != rows.stop - rows.start:
            raise ValueError(
                f"a resumed state of {state['last'].shape[0]} rows; this "
                f"rank holds {rows.stop - rows.start} of the batch of {B}"
                + (f" on {layout}" if layout else ""))
        pos = int(torch.maximum(state["t_cache"]["pos"],
                                state["d_cache"]["pos"]).max())
        if layout is not None:
            pos = layout.host_max(pos, dp)
        _fit_caches(state, pos + K1 * max_steps + 2)
    cap = max_steps + K1 + 1
    carry = init_gen_carry(state, n_vec[rows], cap, eos_id)
    carry = make_gen_loop(t_model.cfg, d_model.cfg, scfg, layout, dp)(
        t_model, d_model, carry,
        torch.as_tensor(n_vec[rows], device=dev), eos_id, max_steps)
    state = carry["state"]
    out = {name: carry[name][:, :cap].cpu().numpy()
           for name in ("toks", "fd", "us", "chs", "msk", "yd", "yt")}
    out.update({name: carry[name].cpu().numpy()
                for name in ("lens", "eos", "total", "acc_total",
                             "alive_steps")})
    out.update(keys=state["keys"].cpu().numpy(),
               strength=state["strength"].cpu().numpy())
    if layout is not None:
        out = layout.gather_rows(out, dp)
    denom = max(int(out["alive_steps"].sum()), 1)
    return GenerationResult(
        tokens=out["toks"].astype(np.int32), lengths=out["lens"],
        from_draft=out["fd"], u=out["us"],
        ctx_hashes=out["chs"].astype(np.uint32), masked=out["msk"],
        aatps=int(out["acc_total"].sum()) / denom,
        tokens_per_step=int(out["total"].sum()) / denom,
        n_steps=carry["n_steps"], state=state, eos=out["eos"],
        y_draft=out["yd"], y_target=out["yt"],
        stat_scheme=make_decoder(scfg).name,
        keys=out["keys"].astype(np.uint32), strength=out["strength"],
        n_syncs=carry["n_syncs"])


def _coerce_serve_config(config, legacy: Dict[str, Any], caller: str):
    """The deprecation shim of the reference: ``config=ServeConfig(...)``
    is the supported surface; the historical keyword arguments
    (``config.LEGACY_KWARGS``) still work but fold into a ``ServeConfig``
    under a ``DeprecationWarning``.  Mixing both, or an unknown keyword,
    raises ``TypeError``."""
    import warnings

    from repro_torch.serve.config import LEGACY_KWARGS, ServeConfig

    unknown = sorted(set(legacy) - set(LEGACY_KWARGS))
    if unknown:
        raise TypeError(f"{caller}() got unexpected keyword arguments "
                        f"{unknown} — accepted: config=ServeConfig(...) "
                        f"or the legacy kwargs {list(LEGACY_KWARGS)}")
    if config is not None:
        if legacy:
            raise TypeError(
                f"{caller}() got both config=ServeConfig(...) and legacy "
                f"keyword arguments {sorted(legacy)} — pass one or the "
                "other")
        return config.validate()
    if "batch" not in legacy or "key" not in legacy:
        raise TypeError(f"{caller}() needs config=ServeConfig(batch=..., "
                        "key=..., ...) (or the deprecated batch=/key= "
                        "kwargs)")
    warnings.warn(
        f"passing serving options to {caller}() as individual keyword "
        "arguments is deprecated — construct a serve.ServeConfig and "
        f"pass config=; the kwargs surface is removed next release",
        DeprecationWarning, stacklevel=3)
    return ServeConfig(**legacy).validate()


def serve_requests(t_model: Model, d_model: Model,
                   scfg: SpecConfig, requests, *, config=None,
                   stats_out: Optional[dict] = None, **legacy):
    """Continuous batching: serve a request list through ``config.batch``
    live slots, admitting queued prompts into freed slots at the loop's
    sync points (``serve.scheduler``).  ``config`` is a
    ``serve.config.ServeConfig``; the reference's individual keyword
    arguments (``batch=``, ``key=``, ...) still work through a deprecation
    shim (``_coerce_serve_config``).  ``requests``: ``scheduler.Request``s,
    ``(prompt, n_tokens)`` pairs or ``{"prompt", "n_tokens"}`` dicts,
    admitted FIFO; ``max_tokens`` / ``max_prompt_len`` default to the
    maxima over the requests.  ``page_size`` switches the KV caches to the
    block-paged pool (``num_pages`` pages shared by all slots, prompts
    admitted in ``prefill_chunk``-token chunks between decode rounds);
    ``prefix_cache=True`` shares identical full-page prompt prefixes
    across requests.  ``on_token(uid, token, meta)`` fires as tokens
    surface at sync points and ``on_result`` per flushed request;
    ``overlap=True`` enqueues each round's snapshot before its decode
    chunk (served bits unchanged, tokens visible one chunk later).
    Returns ``scheduler.RequestResult``s in uid (submission) order, each
    equal to a solo ``generate`` of its prompt/key; ``stats_out={}``
    receives the scheduler's ``stats()``.  For an async-iterator surface
    use ``serve_stream``."""
    from repro_torch.serve.scheduler import Scheduler, as_request

    config = _coerce_serve_config(config, legacy, "serve_requests")
    reqs = [as_request(r) for r in requests]
    if not reqs:
        return []
    config = config.resolved(reqs)
    sched = Scheduler(t_model, d_model, scfg, **config.scheduler_kwargs())
    sched.submit_many(reqs)
    results = sched.run()
    if stats_out is not None:
        stats_out.update(sched.stats())
    return results


async def serve_stream(t_model: Model, d_model: Model, scfg: SpecConfig,
                       requests, *, config=None,
                       stats_out: Optional[dict] = None, **legacy):
    """Async-iterator variant of ``serve_requests``: yields ``(uid, token,
    meta)`` as slots progress and awaits between sync rounds, so other
    coroutines (response writers, request intake) interleave with
    serving.  It takes the same ``config`` (legacy kwargs deprecated), but
    with legacy kwargs ``overlap`` defaults on: a streaming consumer is
    latency-shaped.  Completed ``RequestResult``s arrive through
    ``on_result`` and the aggregates through ``stats_out``, as in
    ``serve_requests``; the yielded streams equal those results."""
    import asyncio

    from repro_torch.serve.scheduler import Scheduler, as_request

    if config is None and "overlap" not in legacy and legacy:
        legacy = dict(legacy, overlap=True)  # streaming's historical default
    config = _coerce_serve_config(config, legacy, "serve_stream")
    reqs = [as_request(r) for r in requests]
    if not reqs:
        return
    config = config.resolved(reqs)
    sched = Scheduler(t_model, d_model, scfg, **config.scheduler_kwargs())
    sched.submit_many(reqs)
    last_round = 0
    for ev in sched.run_stream():
        yield ev
        if ev[2]["round"] != last_round:
            last_round = ev[2]["round"]
            await asyncio.sleep(0)
    if stats_out is not None:
        stats_out.update(sched.stats())
