"""Plain PyTorch versions of the port's kernels — the same functions, step
by step, on any device.  The kernel wrappers in ``ops`` take them for CPU
tensors; the CPU tests hold them against ``repro.kernels.ref``, and
``chip_smoke.py`` holds the CUDA kernels against them.

Tokens, counts and prefix masks are int64; key words and context hashes
are int64 words (``core.prf``).  Unlike the reference's Pallas kernels
nothing is padded to 128 lanes: every function works over exactly V
entries (padding lanes add exact zeros, so only the order of a float sum
can differ)."""
from __future__ import annotations

import torch

from repro_torch.core import prf

EPS = 1e-30


def race_scores(dist: torch.Tensor, seeds: torch.Tensor):
    """Gumbel-race scores log(U_w)/P_w of (B, V) rows (-inf where P_w <= 0)
    and the uniforms U (B, V)."""
    V = dist.shape[-1]
    uv = prf.kernel_uniform(seeds[:, None],
                            torch.arange(V, device=dist.device))
    score = torch.log(uv) / torch.clamp_min(dist, EPS)
    return torch.where(dist > 0, score, -torch.inf), uv


def margin(scores: torch.Tensor) -> torch.Tensor:
    """Race margin of each row: (best − second best) / |best|.  A row under
    1e-5 may pick another token in another framework or on the card (logf
    differs in the last bit), so such rows are counted, never compared."""
    top = torch.topk(scores, 2, dim=-1).values
    return (top[:, 0] - top[:, 1]) / top[:, 0].abs()


def gumbel_argmax_ref(probs: torch.Tensor, seeds: torch.Tensor):
    """probs (B, V) f32, seeds (B,) words -> (tokens (B,), U[token] (B,))."""
    score, uv = race_scores(probs.float(), seeds)
    tok = torch.argmax(score, dim=-1)
    return tok, uv.gather(-1, tok[:, None])[:, 0]


def tournament_rounds(p: torch.Tensor, seeds: torch.Tensor, m: int):
    """m SynthID rounds p <- p·((1 + g) − Σ p·g) of (B, V) rows with
    g = gbit(seed, w + V·l); no normalisation."""
    V = p.shape[-1]
    w = torch.arange(V, device=p.device)
    for layer in range(m):
        g = prf.kernel_gbit(seeds[:, None], w + V * layer)
        mass = (p * g).sum(-1, keepdim=True)
        p = p * (1.0 + g - mass)
    return p


def tournament_keyed_ref(probs, keys, ctx_hashes, *, stream: int, m: int):
    """probs (B, V) f32, keys/ctx (B,) words -> (the m-round distribution
    (B, V), its argmax (B,)).  The g-seed is chain(chain(key, stream),
    ctx), as the kernel derives it."""
    pz = tournament_rounds(probs.float(), prf.wm_seed(keys, ctx_hashes,
                                                      stream), m)
    return pz, torch.argmax(pz, dim=-1)


def accept_prefix(p, q, tokens, u):
    """Alg. 1 acceptance: prefix (B, K) int64 of u < min(1, p/q) at the
    drafted tokens, and n_acc (B,)."""
    K = tokens.shape[1]
    pt = p[:, :K].gather(-1, tokens[..., None])[..., 0]
    qt = q.gather(-1, tokens[..., None])[..., 0]
    a = torch.clamp_max(pt / torch.clamp_min(qt, EPS), 1.0)
    prefix = torch.cumprod((u < a).to(torch.int64), dim=-1)
    return prefix, prefix.sum(-1)


def tail_rows(p, q, n_acc, keys, ctx_hashes, seen, *, streams):
    """The emitted slot's row r = (p − q)_+ (p_K at the bonus slot) and its
    seeds: (r (B, V), seen_s, wm_s, plain_s, draw_s)."""
    wm_stream, plain_resid, plain_bonus, draw_stream = streams
    B, K1, V = p.shape
    K = K1 - 1
    rows = torch.arange(B, device=p.device)
    q_ext = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
    r = torch.clamp_min(p[rows, n_acc] - q_ext[rows, n_acc], 0.0)
    ctx_s = ctx_hashes[rows, n_acc]
    seen_s = seen[rows, n_acc].bool()
    pl_stream = torch.where(n_acc == K, plain_bonus, plain_resid)
    seeds = [prf.wm_seed(keys, ctx_s, s)
             for s in (wm_stream, pl_stream, draw_stream)]
    return (r, seen_s, *seeds)


def spec_verify_wm_ref(p, q, tokens, u, keys, ctx_hashes, seen, live, *,
                       streams, kind: str = "race", m: int = 0,
                       degenerate: bool = False):
    """The fused watermarked tail of Alg. 1 — see ``csrc/spec_verify_wm.cu``.
    p (B, K+1, V), q (B, K, V) f32; tokens (B, K); u (B, K); keys (B,);
    ctx_hashes (B, K+1); seen (B, K+1) bool; live (B,) bool.  Returns
    (n_acc (B,), prefix (B, K), etok (B,), estat) with estat (B,) for
    kind="race" and the token's m g-bits (B, m) for kind="tournament";
    rows with live False are all zeros."""
    p, q = p.float(), q.float()
    V = p.shape[-1]
    prefix, n_acc = accept_prefix(p, q, tokens, u)
    r, seen_s, wm_s, pl_s, dw_s = tail_rows(p, q, n_acc, keys, ctx_hashes,
                                            seen, streams=streams)
    if kind == "race":
        etok, estat = gumbel_argmax_ref(r, torch.where(seen_s, pl_s, wm_s))
    else:
        rn = r / torch.clamp_min(r.sum(-1, keepdim=True), EPS)
        pz = tournament_rounds(rn, wm_s, m)
        race_dist = torch.where(seen_s[:, None], rn, pz)
        race_tok, _ = gumbel_argmax_ref(
            race_dist, torch.where(seen_s, pl_s, dw_s))
        etok = (torch.where(seen_s, race_tok, torch.argmax(pz, dim=-1))
                if degenerate else race_tok)
        layers = torch.arange(m, device=p.device)
        estat = prf.kernel_gbit(wm_s[:, None], etok[:, None] + V * layers)
    lv = live.bool()
    return (torch.where(lv, n_acc, 0), torch.where(lv[:, None], prefix, 0),
            torch.where(lv, etok, 0),
            torch.where(lv if estat.ndim == 1 else lv[:, None], estat, 0.0))


def paged_gather(pool: torch.Tensor, page_table: torch.Tensor):
    """A slot-major dense view of a paged pool: pool (P, page_size, Hkv,
    hd), page_table (B, max_pages) -> (B, max_pages·page_size, Hkv, hd) in
    logical position order.  Null-page (0) tails gather garbage at
    positions past the slot's allocation, which the position gate masks."""
    B, n_pages = page_table.shape
    return pool[page_table].reshape((B, n_pages * pool.shape[1])
                                    + tuple(pool.shape[2:]))


def paged_attention_ref(q, k_pool, v_pool, page_table, pos):
    """The plain version of ``csrc/paged_attention.cu``: the page-table
    gather, then ``layers.decode_attention``'s masked-softmax math over the
    whole gathered extent.  q (B, Sq, H, hd); pools (P, page_size, Hkv,
    hd); page_table (B, max_pages); pos () or (B,): query i attends logical
    kv positions < pos + i.  Returns (B, Sq, H, hd) in the pool's type."""
    from repro_torch.models import layers as L
    B = q.shape[0]
    pos = torch.as_tensor(pos, device=q.device).expand(B)
    return L.decode_attention(q, paged_gather(k_pool, page_table),
                              paged_gather(v_pool, page_table), pos)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at |x| (8 significant bits), in
    float32; 0 where x is 0."""
    x = x.float().abs()
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)
    return torch.where(x > 0, ulp, 0.0)


def paged_attention_tol(q, k_pool, v_pool, page_table, pos, want, *,
                        flips: int = 2):
    """Per-element bound on |kernel - plain version| for bfloat16
    ``paged_attention`` when both keep the plain version's rounding points
    and differ only in the order of their float32 sums.  Such a difference
    can round a q·k score one bf16 ulp the other way (its logit moves by
    ulp·scale, its probability p by p·expm1(ulp·scale)), round a
    probability one ulp the other way (at most 2^-7·p) and round the output
    one ulp the other way.  A flip at position j moves an output element by
    at most Δp_j·(max|v_j| + max|out|); the bound allows ``flips`` flips per
    row, each as large as the row's largest, plus two ulps of each output
    element.  ``want`` is the plain version's output."""
    B, Sq, H, hd = q.shape
    n_rep = H // k_pool.shape[2]
    kd = paged_gather(k_pool, page_table).float().repeat_interleave(n_rep, 2)
    vd = paged_gather(v_pool, page_table).float().repeat_interleave(n_rep, 2)
    scale = hd ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kd).to(q.dtype).float()
    pos = torch.as_tensor(pos, device=q.device).expand(B)
    lim = pos[:, None] + torch.arange(Sq, device=q.device)[None]
    valid = (torch.arange(kd.shape[1], device=q.device)[None, None]
             < lim[:, :, None])[:, None]
    p = torch.softmax(torch.where(valid, s * scale,
                                  torch.finfo(torch.float32).min), -1)
    dp = p * (torch.expm1(bf16_ulp(s) * scale) + 2.0 ** -7)
    out = want.float().transpose(1, 2)                       # (B, H, Sq, hd)
    reach = (vd.abs().amax(-1).transpose(1, 2)[:, :, None]   # (B, H, 1, T)
             + out.abs().amax(-1, keepdim=True))
    per_flip = (dp * reach).amax(-1).transpose(1, 2)         # (B, Sq, H)
    return 2 * bf16_ulp(want) + flips * per_flip[..., None]
