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


def tournament_ref(probs: torch.Tensor, seeds: torch.Tensor, *, m: int):
    """probs (B, V) f32, seeds (B,) words -> the m unnormalised rounds
    (B, V) with each row's host seed (``csrc/tournament.cu``)."""
    return tournament_rounds(probs.float(), seeds, m)


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


def spec_verify_ref(p, q, tokens, u, resid_seeds):
    """The unkeyed Alg. 1 verify (``csrc/spec_verify.cu``): p, q (B, K, V)
    f32; tokens (B, K); u (B, K); resid_seeds (B, K) words.  Returns
    (n_acc (B,), prefix (B, K), the residual token (B,), its U (B,)): a
    Gumbel race over (p − q)_+ at slot min(n_acc, K − 1) with that slot's
    seed, so a row that accepts all K drafts still races slot K − 1, as
    the reference kernel does."""
    p, q = p.float(), q.float()
    prefix, n_acc = accept_prefix(p, q, tokens, u)
    rows = torch.arange(p.shape[0], device=p.device)
    slot = torch.clamp_max(n_acc, tokens.shape[1] - 1)
    r = torch.clamp_min(p[rows, slot] - q[rows, slot], 0.0)
    rtok, ru = gumbel_argmax_ref(r, resid_seeds[rows, slot])
    return n_acc, prefix, rtok, ru


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


def paged_attention_ref(q, k_pool, v_pool, page_table, pos, *, window=0):
    """The plain version of ``csrc/paged_attention.cu``: the page-table
    gather, then ``layers.decode_attention``'s masked-softmax math over the
    gathered extent (max_pages · page_size), with its ``window``.  q (B,
    Sq, H, hd); pools (P, page_size, Hkv, hd); page_table (B, max_pages);
    pos () or (B,): query i attends logical kv positions < pos + i (and,
    under a window smaller than the extent, the positions of its window
    slice).  Returns (B, Sq, H, hd) in the pool's type."""
    from repro_torch.models import layers as L
    B = q.shape[0]
    pos = torch.as_tensor(pos, device=q.device).expand(B)
    return L.decode_attention(q, paged_gather(k_pool, page_table),
                              paged_gather(v_pool, page_table), pos,
                              window=window)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at |x| (8 significant bits), in
    float32; 0 where x is 0."""
    x = x.float().abs()
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)
    return torch.where(x > 0, ulp, 0.0)


def paged_attention_tol(q, k_pool, v_pool, page_table, pos, want, *,
                        flips: int = 2, window: int = 0):
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
    from repro_torch.models import layers as L
    valid, present = L.window_mask(pos, Sq, kd.shape[1], window)
    sc = torch.where(valid[:, None], s * scale,
                     torch.finfo(torch.float32).min)
    p = torch.softmax(torch.where(present[:, None], sc, -torch.inf), -1)
    dp = p * (torch.expm1(bf16_ulp(s) * scale) + 2.0 ** -7)
    out = want.float().transpose(1, 2)                       # (B, H, Sq, hd)
    reach = (vd.abs().amax(-1).transpose(1, 2)[:, :, None]   # (B, H, 1, T)
             + out.abs().amax(-1, keepdim=True))
    per_flip = (dp * reach).amax(-1).transpose(1, 2)         # (B, Sq, H)
    return 2 * bf16_ulp(want) + flips * per_flip[..., None]


def paged_attention_flips(q, k_pool, v_pool, page_table, pos, out, want, *,
                          window: int = 0):
    """(B, Sq, H): the flips each row of ``out`` needs to lie within
    ``paged_attention_tol`` of ``want`` — the largest over the row's
    elements of (|out - want| - two bf16 ulps) over the row's largest
    flip, 0 where the ulps cover it."""
    args = (q, k_pool, v_pool, page_table, pos, want)
    t0 = paged_attention_tol(*args, flips=0, window=window)
    per_flip = (paged_attention_tol(*args, flips=1, window=window)
                - t0)[..., 0]
    excess = ((out.float() - want.float()).abs() - t0).clamp_min(0).amax(-1)
    return torch.where(excess > 0, excess / per_flip.clamp_min(1e-30), 0.0)


# ---------------------------------------------------------------------------
# Recurrent scans and steps (reference kernels/wkv.py, kernels/ssd.py and
# the fused-step mirrors of kernels/ref.py).  Every body casts its inputs
# to float32 first, as the TPU kernels do; the state is always float32.
# ---------------------------------------------------------------------------


def wkv_ref(r, k, v, w, u, s0):
    """The per-timestep RWKV6 WKV recurrence (``wkv.wkv_ref``), the plain
    version of ``csrc/wkv.cu``:

        y_t = r_t · (S + u ⊙ k_t v_tᵀ);   S ← w_t ⊙_rows S + k_t v_tᵀ

    r, k, v, w (B, S, H, hd); u (H, hd); s0 (B, H, hd, hd) (key i, value
    j).  Returns (y (B, S, H, hd) f32, final state (B, H, hd, hd) f32)."""
    u = u.float()
    s = s0.float()
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = (a[:, t].float() for a in (r, k, v, w))
        kv = k_t[..., :, None] * v_t[..., None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r_t,
                               s + u[..., :, None] * kv))
        s = w_t[..., :, None] * s + kv
    return torch.stack(ys, 1), s


def wkv_step_ref(r, k, v, w, u, s0):
    """One WKV step (``ref.wkv_step_ref``), the plain version of
    ``csrc/wkv_step.cu``: multiply then sum over the key axis, the
    reference's op order.  r, k, v, w (B, H, hd); u (H, hd); s0 (B, H, hd,
    hd).  Returns (y (B, H, hd) f32, the new state (B, H, hd, hd) f32)."""
    r, k, v, w = (a.float() for a in (r, k, v, w))
    u = u.float()
    s = s0.float()
    kv = k[..., :, None] * v[..., None, :]
    y = ((s + u[..., :, None] * kv) * r[..., :, None]).sum(-2)
    return y, w[..., :, None] * s + kv


def ssd_ref(la, dtx, Bf, Cf, h0):
    """The per-timestep Mamba2 recurrence (``ssd.ssd_ref``; the scan of
    ``models/ssm.py`` at ``chunk == 0`` or S <= chunk):

        h_t = exp(la_t) h_{t-1} + dtx_t ⊗ B_t;   y_t = h_t · C_t

    la (B, S, H) log-decay (<= 0); dtx (B, S, H, hd); Bf, Cf (B, S, N);
    h0 (B, H, hd, N).  Returns (y (B, S, H, hd) f32, final state f32).  On
    the card this path is the ``ssd_step`` kernel, one launch that walks the
    S steps; its state is S applications of ``ssd_step_ref``, bit for bit
    (the same operations), and its y within ``ssd_tol(..., chunk=0)``."""
    h = h0.float()
    ys = []
    for t in range(la.shape[1]):
        la_t, dtx_t, B_t, C_t = (a[:, t].float() for a in (la, dtx, Bf, Cf))
        h = torch.exp(la_t)[..., None, None] * h \
            + dtx_t[..., None] * B_t[:, None, None, :]
        ys.append(torch.einsum("bhdn,bn->bhd", h, C_t))
    return torch.stack(ys, 1), h


def ssd_step_ref(la, dtx, Bf, Cf, h0):
    """One SSD step (``ref.ssd_step_ref``), the plain version of
    ``csrc/ssd_step.cu``: multiply then sum over N.  la (B, H); dtx (B, H,
    hd); Bf, Cf (B, N); h0 (B, H, hd, N).  Returns (y (B, H, hd) f32, the
    new state (B, H, hd, N) f32)."""
    la, dtx, Bf, Cf = (a.float() for a in (la, dtx, Bf, Cf))
    h = torch.exp(la)[..., None, None] * h0.float() \
        + dtx[..., None] * Bf[:, None, None, :]
    return (h * Cf[:, None, None, :]).sum(-1), h


def ssd_chunked_scan(la, dtx, Bf, Cf, h0, Lc: int):
    """Blocked (SSD) evaluation of the Mamba2 recurrence
    (``models/ssm.py::_ssd_chunked_scan``) over S divisible by Lc: per
    chunk, the masked decay tile exp(cum_i - cum_j) times C·Bᵀ for the
    intra-chunk part, exp(cum_i)·(h·C_i) from the carried state, then
    h <- exp(tot)·h + Σ_j exp(tot - cum_j) dtx_j ⊗ B_j.  Shapes as
    ``ssd_ref``; returns (y (B, S, H, hd), final state)."""
    B, S, H = la.shape
    hd, N = dtx.shape[-1], Bf.shape[-1]
    nc = S // Lc
    la = la.reshape(B, nc, Lc, H)
    dtx = dtx.reshape(B, nc, Lc, H, hd)
    Bc = Bf.reshape(B, nc, Lc, N)
    Cc = Cf.reshape(B, nc, Lc, N)
    cum = torch.cumsum(la, dim=2)                          # (B, nc, Lc, H)
    tot = cum[:, :, -1]                                    # (B, nc, H)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B, nc, i, j, H)
    mask = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                 device=la.device))
    w = torch.where(mask[None, None, :, :, None], torch.exp(diff), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y_intra = torch.einsum("bcijh,bcij,bcjhd->bcihd", w, cb, dtx)
    wj = torch.exp(tot[:, :, None] - cum)
    X = torch.einsum("bcjh,bcjhd,bcjn->bchdn", wj, dtx, Bc)
    h = h0.float()
    y_inter = []
    for c in range(nc):
        yh = torch.einsum("bhdn,bin->bihd", h, Cc[:, c])
        y_inter.append(torch.exp(cum[:, c])[..., None] * yh)
        h = torch.exp(tot[:, c])[..., None, None] * h + X[:, c]
    y = (y_intra + torch.stack(y_inter, 1)).reshape(B, S, H, hd)
    return y, h


def ssd_chunked_ref(la, dtx, Bf, Cf, h0, chunk: int):
    """The plain version of ``csrc/ssd.cu`` (what ``ssd.ssd_kernel``
    computes): chunks of min(chunk, S) tokens, the last one identity-padded
    (la = 0, dtx = B = C = 0 leave the state as it is and add nothing).
    Returns (y (B, S, H, hd) f32, final state (B, H, hd, N) f32)."""
    S = la.shape[1]
    Lc = min(chunk, S)
    pad = (-S) % Lc
    la, dtx, Bf, Cf = (a.float() for a in (la, dtx, Bf, Cf))
    if pad:
        la = torch.nn.functional.pad(la, (0, 0, 0, pad))
        dtx = torch.nn.functional.pad(dtx, (0, 0, 0, 0, 0, pad))
        Bf = torch.nn.functional.pad(Bf, (0, 0, 0, pad))
        Cf = torch.nn.functional.pad(Cf, (0, 0, 0, pad))
    y, h = ssd_chunked_scan(la, dtx, Bf, Cf, h0.float(), Lc)
    return y[:, :S], h


# ---------------------------------------------------------------------------
# Tolerances of the recurrent kernels against their plain versions
# ---------------------------------------------------------------------------

UNIT_ROUNDOFF = 2.0 ** -24     # float32


def gamma(n: float) -> float:
    """γ_n = n·u / (1 − n·u): the relative error bound of a float32
    result that passes through n roundings (a sum of n + 1 terms, or a
    chain of n products and sums)."""
    nu = n * UNIT_ROUNDOFF
    return nu / (1.0 - nu)


def _tol(env, n: float, extra: float = 0.0):
    """Two computations of one quantity, each within (γ_n + extra)·env of
    the exact value, differ by at most twice that (plus the smallest
    normal float32, for outputs whose envelope underflows)."""
    return 2.0 * (gamma(n) + extra) * env + torch.finfo(torch.float32).tiny


def wkv_tol(r, k, v, w, u, s0):
    """Per-element bounds (tol_y, tol_state) on |kernel − plain version|
    for ``wkv`` (r..s0 with a time axis S) or ``wkv_step`` (without one).
    Each output of the recurrence is a sum of products of the inputs with
    nonnegative decays, so the plain version run on |r|, |k|, |v|, |u|,
    |s0| gives its envelope Σ|term|, and a float32 evaluation in any order
    is within γ_D·envelope of the exact value, with D the longest chain of
    roundings to that output: 2 per timestep through the state, hd + 3 to
    a y.  The decay w is an input (not recomputed), so it adds none."""
    if r.dim() == 3:
        y_env, s_env = wkv_step_ref(r.abs(), k.abs(), v.abs(), w, u.abs(),
                                    s0.abs())
        steps = 1
    else:
        y_env, s_env = wkv_ref(r.abs(), k.abs(), v.abs(), w, u.abs(),
                               s0.abs())
        steps = r.shape[1]
    hd = r.shape[-1]
    return (_tol(y_env, 2 * steps + hd + 3), _tol(s_env, 2 * steps + 1))


def ssd_tol(la, dtx, Bf, Cf, h0, chunk: int = 0):
    """Per-element bounds (tol_y, tol_state) on |kernel − plain version|
    for ``ssd_step`` (la (B, H), no time axis), the per-timestep scan
    (``chunk == 0``) or ``ssd`` (chunked).  The envelope is the plain
    version on |dtx|, |B|, |C|, |h0| (decays are positive).  D counts the
    roundings on the longest chain: per timestep 4 for exp(la) (float32
    exp is within 2 ulps) and 2 for the update, N + 2 to a y; per chunk
    N + Lc + hd + 12.  The chunked form also takes exp of cumulative sums,
    which another summation order moves by up to (γ_Lc + u)·Σ|la| of a
    chunk: a relative error of each decay factor, once per chunk."""
    if la.dim() == 2:
        y_env, h_env = ssd_step_ref(la, dtx.abs(), Bf.abs(), Cf.abs(),
                                    h0.abs())
        N = Bf.shape[-1]
        return _tol(y_env, N + 8), _tol(h_env, 6)
    S, hd, N = la.shape[1], dtx.shape[-1], Bf.shape[-1]
    if not chunk:
        y_env, h_env = ssd_ref(la, dtx.abs(), Bf.abs(), Cf.abs(), h0.abs())
        return _tol(y_env, 6 * S + N + 2), _tol(h_env, 6 * S)
    y_env, h_env = ssd_chunked_ref(la, dtx.abs(), Bf.abs(), Cf.abs(),
                                   h0.abs(), chunk)
    Lc = min(chunk, S)
    nc = -(-S // Lc)
    pad = nc * Lc - S
    lsum = torch.nn.functional.pad(la.float().abs(), (0, 0, 0, pad)) \
        .reshape(la.shape[0], nc, Lc, -1).sum(2).max()
    extra = nc * (gamma(Lc) + UNIT_ROUNDOFF) * float(lsum)
    D = nc * (N + Lc + hd + 12)
    return _tol(y_env, D, extra), _tol(h_env, D, extra)


def replay_grad_tol(kernel: str, args, outs, out_tols):
    """Per-input bounds on |∇ − ∇'| for the gradients of Σ y² + Σ state²
    through a recurrence's ``ops.Replay`` (cotangents 2·``outs``, the
    kernel's outputs) and through its plain version straight (cotangents
    from outputs within ``out_tols`` of ``outs``: ``wkv_tol`` /
    ``ssd_tol``).  Both backward passes run the same plain version
    (``wkv_ref``, or ``ssd_ref`` for ``ssd`` and ``ssd_scan``) on the same
    inputs, and a gradient is linear in the cotangent, so they differ by
    the pull-back of a cotangent error of at most 2·tol plus each pass's
    own roundings.  The recurrences are sums of products with positive
    decays, so the plain version on the inputs' absolute values (decays as
    they are) pulls back a nonnegative cotangent to a bound on any
    cotangent of that size: the bound is that pull-back of 2·tol, plus
    twice γ_D times the pull-back of 2·(|out| + tol), with D the longest
    chain of roundings of the reverse pass (twice the forward's: 4S + 2hd
    + 8 for WKV, 12S + 2N + 4 for SSD)."""
    S = args[0].shape[1]
    if kernel == "wkv":
        r, k, v, w, u, s0 = args
        plain, env = wkv_ref, (r.abs(), k.abs(), v.abs(), w, u.abs(),
                               s0.abs())
        D = 4 * S + 2 * r.shape[-1] + 8
    else:
        la, dtx, Bf, Cf, h0 = args
        plain, env = ssd_ref, (la, dtx.abs(), Bf.abs(), Cf.abs(), h0.abs())
        D = 12 * S + 2 * Bf.shape[-1] + 4
    xs = [a.detach().float().requires_grad_() for a in env]
    with torch.enable_grad():
        env_outs = plain(*xs)
        err = torch.autograd.grad(env_outs, xs, [2 * t for t in out_tols],
                                  retain_graph=True)
        size = torch.autograd.grad(
            env_outs, xs, [2 * (o.abs() + t) for o, t in zip(outs, out_tols)])
    return [e + 2.0 * gamma(D) * z + torch.finfo(torch.float32).tiny
            for e, z in zip(err, size)]
