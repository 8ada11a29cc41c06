"""Training loop — the port of ``repro.train.loop``: the LM loss, a
train-step factory (with micro-batch gradient accumulation) and ``fit``.

    model, hist = fit(cfg, synthetic.batches(stream, 16, 64), steps=300)

A step runs on the model's device: on the card the recurrences launch
their kernels in the forward and replay their plain versions in the
backward (``kernels.ops.Replay``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.optim import adamw

Batch = Dict[str, torch.Tensor]


def lm_loss(model: M.Model, batch: Batch, *, remat: bool = False,
            lb_coef: float = 0.01) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross entropy over ``batch["tokens"]`` (B, S+1) (inputs
    [:, :-1], labels [:, 1:], PAD labels masked) plus ``lb_coef``·aux.
    -> (loss, {"ce", "aux"})."""
    tokens = batch["tokens"]
    logits, aux = M.forward(model, {**batch, "tokens": tokens[:, :-1]},
                            remat=remat)
    labels = tokens[:, 1:]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    mask = (labels != 0).float()
    loss = torch.sum(nll * mask) / torch.clamp_min(mask.sum(), 1.0)
    return loss + lb_coef * aux, {"ce": loss, "aux": aux}


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, *,
                    remat: bool = False, microbatches: int = 1) -> Callable:
    """-> train_step(model, opt_state, batch) -> (model, opt_state,
    metrics {"loss", "ce", "aux", "grad_norm", "lr"}), the model of
    ``cfg`` updated in place.  ``microbatches`` > 1 takes the gradients
    of that many equal slices of the batch one after another (the live
    activations shrink by the same factor) and averages them, as the
    reference's scan does."""
    def grads_of(model, params, batch):
        loss, extras = lm_loss(model, batch, remat=remat)
        return loss, extras, torch.autograd.grad(loss, list(params.values()))

    def train_step(model, opt_state, batch):
        if model.cfg != cfg:
            raise ValueError(f"train_step of {cfg.name} got a model of "
                             f"{model.cfg.name}")
        params = dict(model.named_parameters())
        if microbatches == 1:
            loss, extras, grads = grads_of(model, params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            n = b // microbatches
            grads, ce, aux = None, 0.0, 0.0
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                _, extras, g = grads_of(model, params, mb)
                grads = g if grads is None else [a + c for a, c in
                                                 zip(grads, g)]
                ce = ce + extras["ce"].detach()
                aux = aux + extras["aux"].detach()
            inv = 1.0 / microbatches
            grads = [g * inv for g in grads]
            loss = ce * inv + 0.01 * aux * inv
            extras = {"ce": ce * inv, "aux": aux * inv}
        _, opt_state, om = adamw.apply(opt_cfg, params,
                                       dict(zip(params, grads)), opt_state)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in extras.items()}, **om}
        return model, opt_state, metrics

    return train_step


def fit(cfg: ModelConfig, data_iter, *, steps: int, seed: int = 0,
        opt_cfg: Optional[adamw.AdamWConfig] = None, log_every: int = 50,
        params=None, verbose: bool = True, device="cuda"
        ) -> Tuple[M.Model, list]:
    """Train ``steps`` steps on batches of numpy {"tokens": (B, S+1)} from
    ``data_iter``, from ``params``: a model (trained in place, on its own
    device), a reference params tree (through ``convert``), or None (random
    weights from ``seed``), in float32 on ``device``.  -> (model, the loss
    of every step)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=steps, warmup_steps=20)
    if params is None:
        model = M.init_params(cfg, seed=seed, device=device)
    elif isinstance(params, nn.Module):
        model = params
    elif isinstance(params, Mapping):
        model = convert.from_jax_tree(params, cfg, device=device)
    else:
        raise TypeError(f"params: a model, a params tree or None, not "
                        f"{type(params).__name__}")
    dev = model.embed.device
    opt_state = adamw.init(dict(model.named_parameters()))
    step_fn = make_train_step(cfg, opt_cfg)
    hist = []
    for i in range(steps):
        batch = {k: torch.as_tensor(np.asarray(v), dtype=torch.int64,
                                    device=dev)
                 for k, v in next(data_iter).items()}
        model, opt_state, m = step_fn(model, opt_state, batch)
        hist.append(float(m["loss"]))
        if verbose and (i % log_every == 0 or i == steps - 1):
            print(f"  step {i:4d} loss={hist[-1]:.4f} "
                  f"lr={float(m['lr']):.2e} gnorm={float(m['grad_norm']):.2f}")
    return model, hist
