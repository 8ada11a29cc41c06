"""Trade-off curves between watermark strength and sampling efficiency
(Sec. 3.2, Fig. 1; the classes of Eq. (9) and App. C.2) — the port of
``repro.core.tradeoff``.

Monte-Carlo estimates over pseudorandom contexts, as in the paper's App.
C.1 (which uses 1e7 seeds; the default is 2e5), in chunks of
``seed_chunk`` contexts: chunk c of the linear class takes contexts
c·seed_chunk + (0..seed_chunk−1), the composed classes the same plus
1,000,000.  Each chunk's P_ζ rows come from the decoder's batched
``modified_dist`` (the scheme's sampling kernel on the card); the
mixtures, entropies and TVs are plain tensor operations.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core import prf, speculative as spec
from repro_torch.core import watermark as _wm  # noqa: F401  (registers)
from repro_torch.core.strength import entropy, kl, tv
from repro_torch.core.watermark.base import get_decoder

# Appendix C.1's simulated token distributions (the draft concentrates
# mass, the target has higher entropy)
Q_SIM = torch.tensor([0.4, 0.10, 0.12, 0.11, 0.08, 0.06, 0.05, 0.035, 0.025,
                      0.02])
P_SIM = torch.tensor([0.1, 0.13, 0.155, 0.115, 0.235, 0.065, 0.055, 0.05,
                      0.06, 0.035])
# the curves' default key word: the reference's default key,
# jax.random.key(0), collapses to word 0 (prf.as_key_word there)
DEFAULT_KEY = 0


@dataclasses.dataclass
class Curve:
    label: str
    efficiency: np.ndarray   # x-axis: speculative sampling efficiency
    strength: np.ndarray     # y-axis: watermark strength
    gammas: np.ndarray


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _chunk_ctxs(c: int, seed_chunk: int, offset: int, device):
    return torch.arange(seed_chunk, device=device) + c * seed_chunk + offset


def linear_class_curve(decoder_name: str, *, q=Q_SIM, p=P_SIM,
                       n_seeds: int = 200_000, n_gamma: int = 33,
                       n_theta: int = 33, key=None, seed_chunk: int = 20_000,
                       device="cuda", **dec_kw) -> Curve:
    """The linearly watermarked classes (Eq. 9/10): for each γ, strength
    by the entropy identity on (1−γ)P + γP_ζ, and efficiency
    max_θ E_ζ[1 − TV((1−θ)Q + θQ_ζ, (1−γ)P + γP_ζ)]."""
    key = DEFAULT_KEY if key is None else key
    dec = get_decoder(decoder_name, **dec_kw)
    q, p = _on(q, device), _on(p, device)
    gammas = torch.linspace(0.0, 1.0, n_gamma, device=device)
    thetas = torch.linspace(0.0, 1.0, n_theta, device=device)
    ent_acc = torch.zeros(n_gamma, device=device)
    tv_acc = torch.zeros((n_gamma, n_theta), device=device)
    n_chunks = max(1, n_seeds // seed_chunk)
    for c in range(n_chunks):
        ctxs = _chunk_ctxs(c, seed_chunk, 0, device)
        qz = dec.modified_dist(q, key, ctxs, prf.STREAM_DRAFT)     # (n, V)
        pz = dec.modified_dist(p, key, ctxs, prf.STREAM_TARGET)    # (n, V)
        mix_p = ((1 - gammas)[:, None, None] * p[None, None, :]
                 + gammas[:, None, None] * pz[None])               # (G, n, V)
        ent_acc += entropy(mix_p).sum(1)
        mix_q = ((1 - thetas)[:, None, None] * q[None, None, :]
                 + thetas[:, None, None] * qz[None])               # (T, n, V)
        diff = mix_q[None] - mix_p[:, None]                        # (G,T,n,V)
        tv_acc += 0.5 * diff.abs().sum(-1).sum(-1)
    total = n_chunks * seed_chunk
    strength = entropy(p) - ent_acc / total
    efficiency = 1.0 - (tv_acc / total).min(1).values
    return Curve(label=f"linear/{dec.name}",
                 efficiency=efficiency.cpu().numpy(),
                 strength=strength.cpu().numpy(),
                 gammas=gammas.cpu().numpy())


def composed_class_curve(decoder_name: str, kind: str, *, q=Q_SIM, p=P_SIM,
                         n_seeds: int = 200_000, n_gamma: int = 33, key=None,
                         seed_chunk: int = 20_000, device="cuda",
                         **dec_kw) -> Curve:
    """Hu's class (``kind="hu"``) or Google's (``"google"``), App. C.2: the
    draft decoder fixed (θ = 1) and the target family (1−γ)·S_base +
    γ·S_target with S_base = A_spec(Q,P)∘Q_ζ (Hu) or A_ξ(Q,P)∘Q_ζ with a
    watermarked residual (Google)."""
    if kind not in ("hu", "google"):
        raise ValueError(f"kind must be 'hu' or 'google', got {kind!r}")
    key = DEFAULT_KEY if key is None else key
    dec = get_decoder(decoder_name, **dec_kw)
    q, p = _on(q, device), _on(p, device)
    gammas = torch.linspace(0.0, 1.0, n_gamma, device=device)
    ws_acc = torch.zeros(n_gamma, device=device)
    tv_acc = torch.zeros(n_gamma, device=device)
    n_chunks = max(1, n_seeds // seed_chunk)
    for c in range(n_chunks):
        ctxs = _chunk_ctxs(c, seed_chunk, 1_000_000, device)
        qz = dec.modified_dist(q, key, ctxs, prf.STREAM_DRAFT)
        pz_t = dec.modified_dist(p, key, ctxs, prf.STREAM_TARGET)
        if kind == "hu":
            base = spec.apply_spec_kernel(qz, p[None], q[None])
        else:
            resid_z = dec.modified_dist(spec.residual_dist(p, q), key, ctxs,
                                        prf.STREAM_TARGET + 1)
            base = spec.apply_google_kernel(qz, p[None], q[None], resid_z)
        mix = ((1 - gammas)[:, None, None] * base[None]
               + gammas[:, None, None] * pz_t[None])               # (G, n, V)
        ws_acc += kl(mix, p[None, None, :]).sum(1)
        tv_acc += tv(qz[None], mix).sum(1)
    total = n_chunks * seed_chunk
    return Curve(label=f"{kind}/{dec.name}",
                 efficiency=(1.0 - tv_acc / total).cpu().numpy(),
                 strength=(ws_acc / total).cpu().numpy(),
                 gammas=gammas.cpu().numpy())


def reference_points(q=Q_SIM, p=P_SIM, device="cuda") -> Dict[str, float]:
    """Fig. 1's markers: standard speculative efficiency 1 − TV and the
    maximal strength Ent(P) (the red star Alg. 1 attains)."""
    q, p = _on(q, device), _on(p, device)
    return {"std_spec_efficiency": float(1.0 - tv(q, p)),
            "max_strength": float(entropy(p)),
            "entropy_q": float(entropy(q))}
