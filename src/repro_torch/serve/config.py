"""ServeConfig: the serving layer's one configuration record — a copy of
``repro.serve.config``.

``engine.serve_requests`` and ``scheduler.Scheduler`` take batch sizing,
the paged-pool knobs, multi-tenant keying and the streaming callbacks
through one frozen dataclass with centralized combo validation
(``validate()``)::

    cfg = ServeConfig(batch=8, key=key, max_tokens=128, eos_id=0,
                      page_size=16, num_pages=200, prefill_chunk=32)
    results = E.serve_requests(t_model, d_model, scfg, requests,
                               config=cfg)

Combo rules enforced by ``validate()``:

- ``page_size`` and ``num_pages`` come together; ``prefill_chunk`` and
  ``prefix_cache`` require them;
- dense mode (``page_size=None``) rejects every paged-only knob instead
  of silently ignoring it;
- ``sync_every >= 1``, ``batch >= 1``, positive pool/chunk sizes.

The historical keyword arguments (``LEGACY_KWARGS``) still work through
the deprecation shim of ``serve_requests`` / ``serve_stream``
(``engine._coerce_serve_config``): they fold into a ``ServeConfig`` under
a ``DeprecationWarning``.

``overlap=True`` doubles the paged page-growth horizon: size
``num_pages`` for two chunks of per-slot advance, or ``_ensure_pages``
raises mid-flight.  ``mesh`` (a ``DeviceMesh``, ``launch.mesh``) serves
sharded, as ``engine.generate(mesh=...)`` runs; ``shard_params=False``
keeps the models whole on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

# the reference's legacy serve_requests/serve_stream keyword surface, in
# declaration order — the deprecation shim folds these into a ServeConfig
LEGACY_KWARGS = ("batch", "key", "max_tokens", "max_prompt_len", "eos_id",
                 "sync_every", "mesh", "shard_params", "page_size",
                 "num_pages", "prefill_chunk", "prefix_cache", "key_pool",
                 "strength_controller", "overlap", "on_token", "on_result")

# the fields Scheduler(...) takes as keyword arguments
SCHEDULER_FIELDS = LEGACY_KWARGS


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Everything the serving layer needs beyond models and requests.

    ``batch``/``key`` are required; ``max_tokens``/``max_prompt_len``
    default to the maxima over the submitted requests (resolved by
    ``serve_requests``, required up front by ``Scheduler``)."""
    batch: int
    key: Any
    max_tokens: Optional[int] = None
    max_prompt_len: Optional[int] = None
    eos_id: Optional[int] = None
    sync_every: int = 8
    mesh: Any = None
    shard_params: bool = True
    # paged KV pool
    page_size: Optional[int] = None
    num_pages: Optional[int] = None
    prefill_chunk: Optional[int] = None
    prefix_cache: bool = False
    # multi-tenant keying
    key_pool: Any = None
    strength_controller: Any = None
    # streaming / overlap
    overlap: bool = False
    on_token: Optional[Callable[[int, int, dict], None]] = None
    on_result: Optional[Callable[[Any], None]] = None

    @property
    def paged(self) -> bool:
        return self.page_size is not None

    def validate(self) -> "ServeConfig":
        """Centralized combo validation; returns self so call sites can
        chain ``ServeConfig(...).validate()``."""
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if self.sync_every < 1:
            raise ValueError(
                f"sync_every must be >= 1, got {self.sync_every}")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError(
                f"max_tokens must be >= 1, got {self.max_tokens}")
        if self.max_prompt_len is not None and self.max_prompt_len < 1:
            raise ValueError(
                f"max_prompt_len must be >= 1, got {self.max_prompt_len}")
        if self.paged:
            if self.num_pages is None:
                raise ValueError("paged KV caching needs num_pages "
                                 "(pass page_size and num_pages together)")
            if self.page_size < 1:
                raise ValueError(
                    f"page_size must be >= 1, got {self.page_size}")
            if self.num_pages < 2:
                raise ValueError(
                    f"num_pages must be >= 2 (page 0 is the reserved "
                    f"null page), got {self.num_pages}")
            if self.prefill_chunk is not None and self.prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        else:
            if self.num_pages is not None or self.prefill_chunk is not None:
                raise ValueError("num_pages/prefill_chunk need page_size "
                                 "(paged mode)")
            if self.prefix_cache:
                raise ValueError("prefix_cache=True needs the paged KV "
                                 "pool (pass page_size and num_pages)")
        return self

    def resolved(self, requests) -> "ServeConfig":
        """Fill ``max_tokens``/``max_prompt_len`` from the request list
        when unset (the ``serve_requests`` defaulting rule)."""
        if not requests:
            return self
        changes = {}
        if self.max_tokens is None:
            changes["max_tokens"] = max(r.n_tokens for r in requests)
        if self.max_prompt_len is None:
            changes["max_prompt_len"] = max(len(r.prompt)
                                            for r in requests)
        return dataclasses.replace(self, **changes) if changes else self

    def scheduler_kwargs(self) -> dict:
        """The keyword dict ``scheduler.Scheduler(...)`` consumes."""
        return {f: getattr(self, f) for f in SCHEDULER_FIELDS}
