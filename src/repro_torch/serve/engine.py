"""Batched speculative decoding with watermarking (Algorithm 1) — the port
of the dense path of ``repro.serve.engine``.

One spec step: K watermarked draft samples from the draft model, one
target ``extend_step`` over the K+1 fed tokens, the ζ^R acceptance coins,
the fused verification tail (``kernels.ops.spec_verify_wm``) or the
decoder-generic tail (``fused="off"``), and the per-row commit.  Every
token the step samples goes through the decoder's batched
``draft_sampler`` or the fused tail, i.e. through a kernel on the card.

``generate`` loops spec steps on the host and reads the ``done`` flags
once per step (one device-to-host sync per spec step); a step in which no
slot is live never runs, so ``n_steps`` equals the reference's.  The KV
caches are written in place, so a resumed ``state`` is consumed.
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
from repro_torch.models.transformer import Transformer
from repro_torch.serve.drafter import get_drafter

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


def init_state(t_model: Transformer, d_model: Transformer, scfg: SpecConfig,
               prompts: torch.Tensor, max_seq: int, key,
               strength=None) -> Dict[str, Any]:
    """Prefill both models on prompts (B, S0) and sample the first token.
    ``key`` is one key word or a (B,) row; ``strength`` None, a scalar or
    (B,)."""
    B, S0 = prompts.shape
    dev = prompts.device
    dec = make_decoder(scfg)
    keys = prf.as_key_words(key, B, device=dev)
    sv = _strength_vec(strength, B, dev)
    t_logits, t_cache = t_model.prefill(prompts, max_seq)
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


def make_spec_step(tcfg, dcfg, scfg: SpecConfig) -> Callable:
    """Build step(t_model, d_model, state, live=None, eos_id=None) ->
    (state, StepOutput).  ``live`` (B,) bool freezes the slots that are
    False (their state rows are carried unchanged); ``eos_id`` truncates
    the emission, and all committed state, at the first EOS."""
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
        t_logits, t_cache = t_model.extend_step(fed, t_cache)
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
        t_cache = dict(t_cache, pos=t_pos0 + out_len)
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
            # frozen pos are overwritten before any read (position gate)
            dead = ~live
            for k in ("window", "last", "last_ctx", "last_u", "last_msk",
                      "last_yd", "last_yt", "n_committed", "hist", "hist_n"):
                d = dead.reshape((-1,) + (1,) * (new_state[k].ndim - 1))
                new_state[k] = torch.where(d, state[k], new_state[k])
            for cn in ("t_cache", "d_cache"):
                new_state[cn] = dict(new_state[cn], pos=torch.where(
                    dead, state[cn]["pos"], new_state[cn]["pos"]))
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
    """Grow the KV caches of a resumed state to ``need`` positions, so the
    continuation's writes stay in bounds (the reference would drop them)."""
    for cn in ("t_cache", "d_cache"):
        cache = state[cn]
        S = cache["k"].shape[2]
        if S < need:
            pad = list(cache["k"].shape)
            pad[2] = need - S
            z = cache["k"].new_zeros(pad)
            state[cn] = dict(cache, k=torch.cat([cache["k"], z], 2),
                             v=torch.cat([cache["v"], z], 2))


def generate(t_model: Transformer, d_model: Transformer, scfg: SpecConfig,
             prompts, *, n_tokens, key, strength=None,
             sync_every: Optional[int] = None,
             state: Optional[Dict[str, Any]] = None,
             eos_id: Optional[int] = None) -> GenerationResult:
    """Run spec steps until every slot reaches its target (scalar or (B,)
    ``n_tokens``) or emits ``eos_id``; finished slots freeze while the
    others continue.  Pass ``state=`` (a previous result's ``.state``) to
    continue where that call stopped.  Runs on the models' device.

    ``sync_every`` is accepted for parity with the reference and checked;
    this loop reads the done flags after every step either way."""
    if sync_every is not None and sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    dev = t_model.embed.device
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                              device=dev)
    B, S0 = prompts.shape
    n_vec = _n_tokens_vec(n_tokens, B)
    max_steps = int(n_vec.max())
    K1 = scfg.K + 1
    if state is None:
        # worst case: a fast slot commits K+1 tokens on every step
        state = init_state(t_model, d_model, scfg, prompts,
                           S0 + 1 + K1 * max_steps + 2, key,
                           strength=strength)
    else:
        state = dict(state)
        _fit_caches(state, int(torch.maximum(
            state["t_cache"]["pos"], state["d_cache"]["pos"]).max())
            + K1 * max_steps + 2)
    step = make_spec_step(t_model.cfg, d_model.cfg, scfg)
    cap = max_steps + K1 + 1
    S = state["last_yd"].shape[-1]
    eos_val = -1 if eos_id is None else int(eos_id)

    def buf(first, dtype, extra=()):
        b = torch.zeros((B, cap + 1) + extra, dtype=dtype, device=dev)
        b[:, 0] = first
        return b

    toks = buf(state["last"], torch.int64)
    fd = buf(0, torch.int8)
    us = buf(state["last_u"], torch.float32)
    chs = buf(state["last_ctx"], torch.int64)
    msk = buf(state["last_msk"], torch.bool)
    yd = buf(state["last_yd"], torch.float32, (S,))
    yt = buf(state["last_yt"], torch.float32, (S,))
    n_tok = torch.as_tensor(n_vec, device=dev)
    lens = torch.ones(B, dtype=torch.int64, device=dev)
    eos = state["last"] == eos_val
    done = eos | (n_tok <= 1)
    total = torch.zeros(B, dtype=torch.int64, device=dev)
    acc_total = torch.zeros_like(total)
    alive_steps = torch.zeros_like(total)
    rows = torch.arange(B, device=dev)[:, None]
    idx = torch.arange(K1, device=dev)[None]
    n_steps = n_syncs = 0
    while n_steps < max_steps:
        n_syncs += 1
        if bool(done.all()):
            break
        live = ~done
        state, outp = step(t_model, d_model, state, live=live,
                           eos_id=eos_id)
        pos = lens[:, None] + idx
        emitted = (idx < outp.out_len[:, None]) & live[:, None]
        is_eos = emitted & (outp.out_tokens == eos_val)
        valid = emitted & (pos < cap)
        pos = torch.where(valid, pos, cap)
        o_u = torch.cat([outp.u, torch.zeros((B, 1), device=dev)], 1)
        for b, vals in ((toks, outp.out_tokens),
                        (fd, outp.from_draft.to(torch.int8)),
                        (us, o_u), (chs, outp.ctx_hashes),
                        (msk, outp.masked), (yd, outp.y_draft),
                        (yt, outp.y_target)):
            v = valid[..., None] if vals.ndim == 3 else valid
            b[rows, pos] = torch.where(v, vals, 0).to(b.dtype)
        lens = lens + valid.sum(1)
        eos = eos | is_eos.any(1)
        alive = live.to(torch.int64)
        done = done | eos | (lens >= n_tok)
        total += outp.out_len * alive
        acc_total += outp.n_accepted * alive
        alive_steps += alive
        n_steps += 1
    denom = max(int(alive_steps.sum()), 1)
    dec = make_decoder(scfg)

    def host(t):
        return t[:, :cap].cpu().numpy()

    return GenerationResult(
        tokens=host(toks).astype(np.int32), lengths=lens.cpu().numpy(),
        from_draft=host(fd), u=host(us),
        ctx_hashes=host(chs).astype(np.uint32), masked=host(msk),
        aatps=int(acc_total.sum()) / denom,
        tokens_per_step=int(total.sum()) / denom, n_steps=n_steps,
        state=state, eos=eos.cpu().numpy(), y_draft=host(yd),
        y_target=host(yt), stat_scheme=dec.name,
        keys=state["keys"].cpu().numpy().astype(np.uint32),
        strength=state["strength"].cpu().numpy(), n_syncs=n_syncs)
