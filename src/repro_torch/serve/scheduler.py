"""Continuous batching over the engine's generation loop — the port of
``repro.serve.scheduler``.

The engine's loop (``engine.make_gen_loop``) stops per slot (per-slot
``n_tokens`` targets and EOS) and freezes finished slots (masked commits,
frozen per-slot state, ``live``-masked verification rows).  This module
adds the serving layer on top:

- a FIFO **request queue** (admission order == submission order);
- a per-slot **lifecycle** FREE → PREFILLING → DECODING → DRAINED → FREE;
- **admission at sync points**: every ``sync_every`` engine steps the loop
  returns to the host; drained slots are flushed and queued prompts are
  admitted into the freed slots of the live batch state.

Dense mode scatters a batch-1 prefill into slot ``b`` of every state and
buffer row.  Paged mode (``page_size=`` + ``num_pages=``) keeps the KV
caches in a block-paged pool shared by all slots (per-slot page tables,
``PageAllocator``): a slot holds only the pages its committed prefix
needs, grown at sync points, and prompts prefill in ``prefill_chunk``-token
chunks, one chunk per slot per sync round, interleaved with decode.
``prefix_cache=True`` shares identical page-aligned prompt prefixes across
requests through a refcounted allocator and a ``PrefixCache`` of chain
digests; KV pages depend only on prompt tokens and weights, never on the
per-slot watermark key/strength rows, so sharing is sound across tenants.
A recurrent draft (``serve.drafter``) keeps its state in dense rows outside
the pool and admits through ``extend_step`` chunks; it refuses
``prefix_cache=True`` (its state must see the whole prompt), a hybrid
draft serves in dense mode only, and a recurrent target is refused in
paged mode.

The contract is **slot isolation**: a request's committed tokens,
provenance flags (``src``), acceptance coins, context hashes and
repeated-context masks equal a solo ``engine.generate()`` of the same
prompt and key, whatever the other slots do.  It requires
``accept="pseudorandom"``.  (The dense caches of the two runs differ in
extent, and PyTorch's CPU softmax can round the last bit differently over
another extent, so a token can part only at a near-tie; the tests count
such rows by their margin.)  With ``key_pool=`` (``serve.keys.KeyPool``)
each request is served under its own key word.

The device work is eager PyTorch: admission, chunks and finalize are
plain functions on the state's tensors (written in place).  Each sync
round reads the round's flags and the live slots' buffer rows to the host
in ONE transfer (``device_get``): ``_snap_handles`` enqueues copies of
them into pinned host memory and an event after those copies, and
``device_get`` waits on that event alone.  With ``overlap=True`` the
copies are enqueued before the round's decode chunk, so the snapshot is
the chunk's *input*: a token surfaces one round after it commits, a slot
that finishes inside the chunk flushes one round later, and no served bit
changes (admission lands between chunks in stream order either way).
A ``strength_controller`` (``serve.keys.StrengthController``) resolves a
request's ``tier`` to the strength γ of its slot at admission.

Sharded serving (``mesh=``, every rank building the same Scheduler and
submitting the same requests): the models are sharded as
``engine.generate(mesh=...)`` shards them, and the slots split over the
mesh's dp axes (``Layout.rows``): each rank's engine state, caches and
buffers hold its own slots' rows.  Every rank runs the same host logic
on the same queue (the same allocator and prefix cache, so the same page
ids); the round's snapshot is the one ``device_get`` of this rank's rows
plus one all-gather over dp, so every rank flushes and admits alike.  A
dense admission runs on the slot's dp shard (and its "model" peers); a
shard whose weights are gathered over "data" makes the same model calls
on zero rows, so that its gathers meet the holder's.  The paged pool is
replicated over dp, its kv heads over "model": every shard writes every
admission chunk's pages into its copy, so a prefix page one shard's slot
wrote is there for another's; decode writes only its own slots' pages.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict, deque
from typing import (Any, Callable, Deque, Dict, Iterator, List, Optional,
                    Sequence, Set, Tuple)

import numpy as np
import torch

from repro_torch.models.model import is_recurrent
from repro_torch.serve import engine as E
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.drafter import get_drafter, paged_slot_extend
from repro_torch.serve.keys import _word_of
from repro_torch.sharding import spmd

# ---------------------------------------------------------------------------
# Slot lifecycle
# ---------------------------------------------------------------------------

FREE = "FREE"                # no request; done-masked in the loop
PREFILLING = "PREFILLING"    # batch-1 prefill being scattered into the slot
DECODING = "DECODING"        # live in the jitted loop
DRAINED = "DRAINED"          # finished (target/EOS); awaiting flush

PHASES = (FREE, PREFILLING, DECODING, DRAINED)


@dataclasses.dataclass
class Request:
    """One prompt to serve.  ``n_tokens`` counts post-prompt tokens
    (including the prefill sample), exactly like ``generate()``.

    ``key`` (optional) pins the watermark key word this request is served
    under (any form ``prf.as_key_word`` accepts); ``tier`` (optional)
    names a strength class for the scheduler's ``StrengthController``
    ("latency"/"balanced"/"assurance" by default)."""
    prompt: np.ndarray
    n_tokens: int
    uid: int = -1
    key: Optional[int] = None
    tier: Optional[str] = None


_REQUEST_FIELDS = ("prompt", "n_tokens", "uid", "key", "tier")


def as_request(r) -> Request:
    """Normalize the accepted intake formats — a ``Request``, a
    ``{"prompt": ..., "n_tokens": ..., ["uid"/"key"/"tier"]}`` dict, or a
    ``(prompt, n_tokens)`` pair — to a ``Request`` (the single parser
    shared by ``Scheduler.submit_many`` and ``engine.serve_requests``).
    Unknown dict fields raise: a silently dropped ``key`` would serve a
    request under the wrong watermark key."""
    if isinstance(r, Request):
        return r
    if isinstance(r, dict):
        unknown = sorted(set(r) - set(_REQUEST_FIELDS))
        if unknown:
            raise ValueError(f"unknown request fields {unknown} — "
                             f"accepted: {list(_REQUEST_FIELDS)}")
        return Request(prompt=np.asarray(r["prompt"], np.int32),
                       n_tokens=int(r["n_tokens"]),
                       uid=int(r.get("uid", -1)),
                       key=r.get("key"), tier=r.get("tier"))
    return Request(prompt=np.asarray(r[0], np.int32), n_tokens=int(r[1]))


@dataclasses.dataclass
class RequestResult:
    """Per-request output, truncated to the committed length.  The arrays
    are bit-identical to a solo ``generate()`` of the same prompt/key."""
    uid: int
    tokens: np.ndarray        # (n,) committed tokens (post-prompt)
    src: np.ndarray           # (n,) int8 — 1 = accepted draft token
    u: np.ndarray             # (n,) acceptance coins aligned to slots
    ctx_hashes: np.ndarray    # (n,) uint32
    masked: np.ndarray        # (n,) bool repeated-context flags
    length: int
    eos: bool                 # stopped on eos_id (EOS token committed)
    alive_steps: int          # engine steps this request was live for
    n_accepted: int           # accepted draft tokens over those steps
    n_emitted: int            # emitted tokens over those steps
    y_draft: Optional[np.ndarray] = None    # (n, stat_dim) served zeta^D
    #                                         detection statistics
    y_target: Optional[np.ndarray] = None   # (n, stat_dim), zeta^T
    stat_scheme: Optional[str] = None       # decoder the stats belong to
    key_word: Optional[int] = None          # uint32 watermark key word the
    #                                         request was served under
    strength: float = 1.0                   # gamma the request ran at
    tier: Optional[str] = None              # strength class, when given
    ttft_s: Optional[float] = None          # submit -> first token visible
    #                                         at a sync point (host wall)
    arrivals_s: Optional[np.ndarray] = None  # (n,) per-token visibility
    #   times relative to submit; tokens surfacing in the same sync round
    #   share a timestamp, so gaps within a round are 0

    @property
    def gaps_s(self) -> Optional[np.ndarray]:
        """Inter-token gaps (n-1,); non-negative by construction."""
        if self.arrivals_s is None or len(self.arrivals_s) < 2:
            return None
        return np.diff(self.arrivals_s)

    @property
    def key_fingerprint(self) -> Optional[str]:
        """8-hex fingerprint of the serving key (what logs/replays carry —
        never key material)."""
        if self.key_word is None:
            return None
        return format(int(np.uint32(self.key_word)), "08x")

    @property
    def aatps(self) -> float:
        return self.n_accepted / max(self.alive_steps, 1)

    @property
    def tokens_per_step(self) -> float:
        return self.n_emitted / max(self.alive_steps, 1)

    def as_generation_result(self) -> E.GenerationResult:
        """A batch-1 ``GenerationResult`` view, so the detection pipeline
        (``pipeline.records_from_generation``) consumes scheduler output
        unchanged — including the served detection-stat buffers and the
        per-slot key/strength rows the served-stat gate checks."""
        kw = None if self.key_word is None else \
            np.array([self.key_word], np.uint32)
        return E.GenerationResult(
            tokens=self.tokens[None], lengths=np.array([self.length]),
            from_draft=self.src[None], u=self.u[None],
            ctx_hashes=self.ctx_hashes[None], masked=self.masked[None],
            aatps=self.aatps, tokens_per_step=self.tokens_per_step,
            n_steps=self.alive_steps, eos=np.array([self.eos]),
            y_draft=None if self.y_draft is None else self.y_draft[None],
            y_target=None if self.y_target is None else self.y_target[None],
            stat_scheme=self.stat_scheme, keys=kw,
            strength=np.array([self.strength], np.float32))


@dataclasses.dataclass
class _Slot:
    phase: str = FREE
    request: Optional[Request] = None


class PageAllocator:
    """Host-side **refcounted** free-list allocator over the physical KV
    page pool.

    Page 0 is the reserved **null page**: it is never handed out, and an
    all-zero page-table row aliases every logical page to it — so freed
    slots (whose frozen loop iterations still write k/v) scribble into
    garbage no reader ever attends, instead of into pages that may have
    been reallocated to a new request.  The allocatable set is therefore
    ``{1, .., num_pages - 1}``.

    Refcounts let multiple readers hold the same physical page (prefix
    sharing): ``alloc`` hands out pages at refcount 1, ``share`` takes an
    extra reference on a held page, and ``free`` *decrements* — a page
    returns to the free list only when its last reference drops.  Shared
    pages are read-only by construction (only completely written prompt
    pages are ever shared; decode appends at ``pos >= S0`` and rollback
    is pos-only), so no copy-on-write is needed.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is the "
                             f"reserved null page), got {num_pages}")
        self.num_pages = num_pages
        # stored descending so pop() hands out ascending ids (stable,
        # test-friendly); correctness never depends on the order
        self._free = list(range(num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}       # page -> refcount (>= 1)
        self.n_used_peak = 0                  # high-water mark of n_used

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._refs)

    def refcount(self, page: int) -> int:
        """Current reference count of ``page`` (0 if free)."""
        return self._refs.get(int(page), 0)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages off the free list at refcount 1; raises
        ``RuntimeError`` on exhaustion (never hands out the null page or
        a held page twice)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise RuntimeError(
                f"KV page pool exhausted: need {n} pages, "
                f"{len(self._free)} of {self.num_pages - 1} free")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        self.n_used_peak = max(self.n_used_peak, len(self._refs))
        return out

    def share(self, page: int) -> int:
        """Take one more reference on an already-held page (prefix-cache
        hit pointing a new slot's table at it); the null page and free /
        foreign ids raise."""
        page = int(page)
        if page not in self._refs:
            raise ValueError(f"sharing page {page} that is not allocated "
                             "(free, null page, or foreign id)")
        self._refs[page] += 1
        return self._refs[page]

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; a page returns to the free list
        when its count hits 0.  Over-frees and foreign ids raise."""
        for p in pages:
            p = int(p)
            if p not in self._refs:
                raise ValueError(f"freeing page {p} that is not allocated "
                                 "(double free, null page, or foreign id)")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)


@dataclasses.dataclass
class _PrefixEntry:
    """One cached full page of prompt KV: the physical page plus its
    position in the hash chain (parent = digest of the preceding block,
    ``None`` at the root)."""
    page: int
    parent: Optional[str]
    children: Set[str] = dataclasses.field(default_factory=set)


class PrefixCache:
    """Content-addressed cache of **full, immutable** prompt-prefix pages.

    Keys are chain digests over page-aligned token blocks:
    ``d_j = H(d_{j-1} || prompt[j*ps:(j+1)*ps])`` — so a digest commits to
    the *entire* prefix through block ``j``, and two prompts share page
    ``j`` iff their first ``(j+1)*ps`` tokens are identical.  KV contents
    are a pure function of those tokens and the weights (never of the
    per-slot watermark key/strength rows), which is exactly why sharing
    is sound across tenants.

    Only blocks fully covered by ``prompt[:S0-1]`` are share-eligible
    (``(S0 - 1) // page_size`` of them): the last prompt token always
    prefills privately so finalize has last-position logits to sample
    from, and decode appends land at ``pos >= S0`` — never inside a
    shared page.  The cache holds its own allocator reference per entry
    (entries survive the inserting slot's flush); eviction pops LRU
    entries whose page refcount is 1 (cache-only) and cascades to their
    descendants — a slot always references a *contiguous* chain from the
    root, so refcounts are monotone non-increasing along a chain and an
    evictable parent implies evictable children."""

    def __init__(self, allocator: PageAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = int(page_size)
        self._entries: "OrderedDict[str, _PrefixEntry]" = OrderedDict()
        self.hits = 0          # blocks served from cache, cumulative
        self.misses = 0        # share-eligible blocks prefilled privately
        self.evictions = 0     # entries evicted, cumulative
        self.pages_saved = 0   # pages an admission shared instead of
        #                        allocating + prefilling (bumped by the
        #                        scheduler at admit time, not on lookups)

    # -- introspection -----------------------------------------------------

    @property
    def n_entries(self) -> int:
        return len(self._entries)

    @property
    def pages_held(self) -> int:
        """Pages the cache currently references (one per entry)."""
        return len(self._entries)

    # -- keying ------------------------------------------------------------

    @staticmethod
    def block_digest(parent: Optional[str], block: np.ndarray) -> str:
        h = hashlib.sha256()
        h.update((parent or "").encode("ascii"))
        h.update(np.ascontiguousarray(block, np.int32).tobytes())
        return h.hexdigest()

    def shareable_blocks(self, prompt: np.ndarray) -> int:
        """Number of share-eligible full pages: those covered by
        ``prompt[:S0-1]`` (the uncached tail keeps >= 1 token)."""
        return (len(prompt) - 1) // self.page_size

    def _chain(self, prompt: np.ndarray) -> List[str]:
        digests, parent = [], None
        ps = self.page_size
        for j in range(self.shareable_blocks(prompt)):
            d = self.block_digest(parent, prompt[j * ps:(j + 1) * ps])
            digests.append(d)
            parent = d
        return digests

    # -- lookup / insert / evict -------------------------------------------

    def lookup(self, prompt: np.ndarray) -> tuple:
        """Longest cached prefix chain of the prompt's share-eligible
        blocks -> ``(digests, pages)``.  Hits refresh LRU recency
        (ancestors first, so a chain evicts leaf-before-root).  No
        references are taken — the caller ``share``s each page only once
        admission is certain."""
        digests: List[str] = []
        pages: List[int] = []
        for d in self._chain(prompt):
            e = self._entries.get(d)
            if e is None:
                break
            digests.append(d)
            pages.append(e.page)
        for d in digests:
            self._entries.move_to_end(d)
        self.hits += len(digests)
        self.misses += self.shareable_blocks(prompt) - len(digests)
        return digests, pages

    def insert_chain(self, prompt: np.ndarray, hit_digests: List[str],
                     slot_pages: Sequence[int]) -> int:
        """Register a finalized slot's freshly written full-prefix pages
        (the blocks *after* its admission-time hits).  The cache takes
        its own allocator reference per new entry, so the pages outlive
        the slot's flush.  A digest that raced in via another slot keeps
        the incumbent entry (identical content — same token chain, same
        weights); the caller's private page stays private.  Returns the
        number of entries inserted."""
        chain = self._chain(prompt)
        parent = hit_digests[-1] if hit_digests else None
        inserted = 0
        for j in range(len(hit_digests), len(chain)):
            d = chain[j]
            incumbent = self._entries.get(d)
            if incumbent is not None:
                self._entries.move_to_end(d)
                parent = d
                continue
            page = int(slot_pages[j])
            self.allocator.share(page)
            self._entries[d] = _PrefixEntry(page=page, parent=parent)
            if parent is not None and parent in self._entries:
                self._entries[parent].children.add(d)
            inserted += 1
            parent = d
        return inserted

    def evict(self, n_pages: int, protect: Set[str] = frozenset()) -> int:
        """Free >= ``n_pages`` pages if possible by evicting LRU entries
        whose page refcount is 1 (cache-only — pages still referenced by
        live slots are skipped) and are not in ``protect`` (the hit chain
        of the admission that triggered the eviction).  Evicting an entry
        cascades to its descendants (see class docstring).  Returns the
        number of pages actually returned to the free list."""
        freed = 0
        for d in list(self._entries):
            if freed >= n_pages:
                break
            e = self._entries.get(d)
            if e is None or d in protect:
                continue           # already cascaded away, or protected
            if self.allocator.refcount(e.page) > 1:
                continue           # a live slot still reads this page
            freed += self._evict_subtree(d)
        return freed

    def _evict_subtree(self, d: str) -> int:
        e = self._entries.pop(d)
        if e.parent is not None and e.parent in self._entries:
            self._entries[e.parent].children.discard(d)
        freed = 0
        for c in list(e.children):
            if c in self._entries:
                freed += self._evict_subtree(c)
        assert self.allocator.refcount(e.page) == 1, \
            f"evicting cached page {e.page} still referenced by a slot"
        self.allocator.free([e.page])
        self.evictions += 1
        return freed + 1

    def clear(self) -> int:
        """Drop every entry (all must be cache-only) and return the pages
        to the pool; returns the number of pages freed."""
        return self.evict(len(self._entries))


def _host_copy(tree):
    """Enqueue a copy of every tensor of ``tree`` (nested dicts) to the
    host without waiting.  A CUDA tensor goes by ``copy_(...,
    non_blocking=True)`` into a fresh pinned tensor (into pageable memory
    the copy would be synchronous; a pinned block returns to PyTorch's
    host cache only once its copy has run, so no pending copy is
    overwritten), and one event is recorded after the copies as
    ``"ready"``.  A CPU tensor is cloned: the caller's buffers may be
    written in place before ``device_get`` reads them."""
    on_card = False

    def walk(x):
        nonlocal on_card
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if not isinstance(x, torch.Tensor):
            return x
        if x.device.type != "cuda":
            return x.clone()
        on_card = True
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return out.copy_(x, non_blocking=True)

    out = walk(tree)
    ready = None
    if on_card:
        ready = torch.cuda.Event()
        ready.record()
    return dict(out, ready=ready)


def device_get(handles):
    """The port's ``jax.device_get``, and the one point where a sync round
    waits on the device outside the decode chunk and admission's own
    compute: wait on the event of ``_host_copy`` (none on a CPU tree),
    then hand back the round's view as numpy — ``flags`` and, per live
    slot, its ``rows``."""
    if handles["ready"] is not None:
        handles["ready"].synchronize()
    flags = {k: v.numpy() for k, v in handles["flags"].items()}
    got = {k: v.numpy() for k, v in handles["rows"].items()}
    rows = {b: {k: v[i] for k, v in got.items()}
            for i, b in enumerate(handles["live"])}
    return {"flags": flags, "rows": rows}


class Scheduler:
    """Continuous batching: ``batch`` live slots fed from a FIFO queue,
    with admission and flush at the loop's sync points.

    ``max_tokens`` bounds any request's ``n_tokens`` (it sizes the output
    buffers); ``max_prompt_len`` bounds prompt lengths (it sizes the KV
    caches).  ``eos_id`` (optional) ends any slot that emits it.

    Paged mode (``page_size=`` + ``num_pages=``): KV lives in a shared
    pool of pages; a slot's footprint is the pages its committed prefix
    needs, grown at sync points.  Pool exhaustion while *growing a live
    slot* raises ``RuntimeError`` (no mid-request eviction) — size
    ``num_pages`` for the worst-case live footprint; admission itself
    waits for pages (head-of-line, FIFO kept).  ``prefix_cache=True``
    shares full prompt-prefix pages across requests; cold cache entries
    are evicted LRU when the pool runs short.

    Every sync round reads the flags and the live slots' buffer rows to
    the host once and surfaces newly committed tokens through
    ``on_token`` / ``run_stream()`` before flushing; per-request TTFT and
    inter-token gaps land in ``RequestResult`` and ``stats()``."""

    def __init__(self, t_model, d_model, scfg: E.SpecConfig, *, batch: int,
                 key, max_tokens: int, max_prompt_len: int = 64,
                 eos_id: Optional[int] = None, sync_every: int = 8,
                 mesh=None, shard_params: bool = True,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = False,
                 key_pool=None, strength_controller=None,
                 overlap: bool = False,
                 on_token: Optional[Callable[[int, int, dict], None]] = None,
                 on_result: Optional[Callable[[RequestResult], None]] = None):
        if scfg.accept != "pseudorandom":
            raise ValueError(
                "continuous batching requires accept='pseudorandom': "
                "'standard' coins draw from the global step index, which "
                "depends on the other slots' schedules and would break "
                "slot isolation")
        ServeConfig(batch=batch, key=key, max_tokens=max_tokens,
                    max_prompt_len=max_prompt_len, eos_id=eos_id,
                    sync_every=sync_every, mesh=mesh,
                    shard_params=shard_params, page_size=page_size,
                    num_pages=num_pages, prefill_chunk=prefill_chunk,
                    prefix_cache=prefix_cache, key_pool=key_pool,
                    strength_controller=strength_controller,
                    overlap=overlap, on_token=on_token,
                    on_result=on_result).validate()
        if t_model.cfg.arch_type in ("audio", "vlm"):
            raise ValueError(
                f"continuous batching does not support arch_type="
                f"{t_model.cfg.arch_type!r} yet: admission prefills "
                "text-only prompts and has no per-request modality extras "
                "(audio_emb/image_emb) — use generate(extras=...) with "
                "fixed batches")
        self.t_model, self.d_model = t_model, d_model
        self.tcfg, self.dcfg, self.scfg = t_model.cfg, d_model.cfg, scfg
        self.dev = t_model.embed.device
        self.B = batch
        # this rank's slots (all of them without a mesh, or when the
        # batch does not split), the dp axes they split over, and whether
        # a model call for a slot it does not hold must still be made
        self.layout: Optional[spmd.Layout] = None
        self._dp: tuple = ()
        self._rows = slice(0, batch)
        if mesh is not None:
            self.layout = E.shard(t_model, d_model, mesh, batch, shard_params)
            self._dp = self.layout.dp(batch)
            self._rows = self.layout.rows(batch)
        self._peers = bool(self._dp) and spmd.needs_peers(t_model, d_model)
        local = self._rows.stop - self._rows.start
        self._dec = E.make_decoder(scfg)
        self._stat_scheme = self._dec.name
        # default serving word: every request without a pool/explicit key
        # serves under the scheduler key
        self.key_word = _word_of(key)
        self.key_pool = key_pool
        self.strength_controller = strength_controller
        self._slot_key: List[int] = [self.key_word] * batch
        self._slot_strength: List[float] = [1.0] * batch
        self._slot_tier: List[Optional[str]] = [None] * batch
        self._slot_pooled: List[bool] = [False] * batch
        self.max_tokens = max_tokens
        self.max_prompt_len = max_prompt_len
        self.eos_id = eos_id
        self.sync_every = sync_every
        self.overlap = bool(overlap)
        self.on_token = on_token
        self.on_result = on_result
        K1 = scfg.K + 1
        self.max_seq = max_prompt_len + 1 + K1 * max_tokens + 2
        self.cap = max_tokens + K1 + 1
        # tokens already surfaced per slot, host mirrors of the last
        # snapshot's pos/done (what _ensure_pages plans from), submit times
        # and per-token visibility times keyed by uid
        self._streamed = np.zeros((batch,), np.int64)
        self._pos_host = np.zeros((batch,), np.int64)
        self._done_host = np.zeros((batch,), bool)
        self._t_submit: Dict[int, float] = {}
        self._arrivals: Dict[int, List[float]] = {}
        self.n_rounds = 0

        self._drafter = get_drafter(self.dcfg)
        self.paged = page_size is not None
        if self.paged:
            if is_recurrent(self.tcfg):
                raise ValueError(
                    f"paged KV caching needs an attention *target*; "
                    f"target arch_type={self.tcfg.arch_type!r} keeps O(1) "
                    "recurrent state per slot (nothing to page).  "
                    "Recurrent models are served as *drafters* — their "
                    "state lives dense outside the pool (serve.drafter)")
            if not self._drafter.chunked_extend:
                raise ValueError(
                    f"paged admission needs chunked prefill, which the "
                    f"{self._drafter.name!r} drafter (draft arch_type="
                    f"{self.dcfg.arch_type!r}) does not support — its "
                    "shared-attention sites have no chunked extend.  "
                    "Serve hybrid drafters through the dense path "
                    "(page_size=None)")
            if prefix_cache and not self._drafter.paged_cache:
                raise ValueError(
                    "prefix_cache=True shares resident prompt KV pages, "
                    "but a recurrent drafter's dense state must be "
                    "recomputed over the *full* prompt — prefix hits "
                    "would skip draft-state prefill.  Serve recurrent "
                    "drafters with prefix_cache=False")
            self.page_size = int(page_size)
            self.num_pages = int(num_pages)
            self.prefill_chunk = int(prefill_chunk) if prefill_chunk else 8
            # logical extent of one slot's table: every position a slot can
            # read (writes past it land in the null page)
            self.max_pages = -(-self.max_seq // self.page_size)
            self._alloc = PageAllocator(self.num_pages)
            self._slot_pages: List[List[int]] = [[] for _ in range(batch)]
            self._chunk_cursor = np.zeros((batch,), np.int64)
            self._total_chunks = 0                  # deadlock bound term
            self._prefix = (PrefixCache(self._alloc, self.page_size)
                            if prefix_cache else None)
            # tokens already resident via shared pages at admission: slot
            # b's chunked prefill starts at this offset
            self._prefill_base = np.zeros((batch,), np.int64)
            self._slot_hit_digests: List[List[str]] = \
                [[] for _ in range(batch)]

        self.queue: Deque[Request] = deque()
        self.slots = [_Slot() for _ in range(batch)]
        self.n_tok = np.zeros((batch,), np.int64)   # per-slot targets
        # uids in admission order (the FIFO witness)
        self.admit_order: List[int] = []
        # paged-mode event log: ("admit_chunk", uid, i) / ("finalize", uid)
        # / ("flush", uid) / ("admit_shared", uid, n_cached_tokens)
        self.events: List[tuple] = []
        self.results: Dict[int, RequestResult] = {}
        self._next_uid = 0
        self._total_target = 0                      # deadlock bound
        self._acc = self._emitted = self._alive = 0

        if self.paged:
            # all-null page tables, pos 0: slots fill in place through
            # chunked prefill and the finalize
            state = E.init_empty_paged_state(
                t_model, d_model, scfg, local, num_pages=self.num_pages,
                page_size=self.page_size, max_pages=self.max_pages,
                max_seq=self.max_seq)
        else:
            # a dummy prefill gives the state its shapes; every slot starts
            # FREE (done-masked) and is overwritten by its first admission
            dummy = torch.zeros((local, min(8, max_prompt_len)),
                                dtype=torch.int64, device=self.dev)
            state = E.init_state(t_model, d_model, scfg, dummy,
                                 self.max_seq, self.key_word)
        self.carry = E.init_gen_carry(state, np.ones((local,), np.int64),
                                      self.cap, eos_id)
        self._loop = E.make_gen_loop(self.tcfg, self.dcfg, scfg,
                                     self.layout, self._dp)

    def _row(self, b: int) -> Optional[int]:
        """Slot ``b``'s row in this rank's state, or None where another dp
        shard holds it."""
        r = b - self._rows.start
        return r if 0 <= r < self._rows.stop - self._rows.start else None

    # -- request intake ----------------------------------------------------

    def submit(self, prompt, n_tokens: int, uid: Optional[int] = None,
               key=None, tier: Optional[str] = None) -> int:
        """Queue one prompt; returns its uid (FIFO admission order)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not 1 <= len(prompt) <= self.max_prompt_len:
            raise ValueError(f"prompt length {len(prompt)} outside "
                             f"[1, {self.max_prompt_len}]")
        if not 1 <= n_tokens <= self.max_tokens:
            raise ValueError(f"n_tokens={n_tokens} outside "
                             f"[1, {self.max_tokens}]")
        if uid is None:
            uid = self._next_uid
        elif (uid in self.results
              or any(r.uid == uid for r in self.queue)
              or any(s.request is not None and s.request.uid == uid
                     for s in self.slots)):
            raise ValueError(f"uid {uid} already queued, active or served "
                             "— a duplicate would overwrite its result")
        self._next_uid = max(self._next_uid, uid) + 1
        self.queue.append(Request(prompt=prompt, n_tokens=int(n_tokens),
                                  uid=uid, key=key, tier=tier))
        self._t_submit[uid] = time.perf_counter()
        self._total_target += int(n_tokens)
        if self.paged:
            self._total_chunks += -(-len(prompt) // self.prefill_chunk)
        return uid

    def submit_many(self, requests: Sequence) -> List[int]:
        """Queue requests in order (see ``as_request`` for the accepted
        formats)."""
        return [self.submit(r.prompt, r.n_tokens,
                            uid=None if r.uid < 0 else r.uid,
                            key=r.key, tier=r.tier)
                for r in map(as_request, requests)]

    # -- admission (sync point) --------------------------------------------

    def _arm_buffers(self, b: int, first: Dict[str, torch.Tensor],
                     n_tok_b: int) -> None:
        """Reset buffer row ``b`` (this rank's row of the slot) and its
        flags for a new request: buffer slot 0 takes the prefill sample
        and its metadata (``first`` holds (1, ...) rows: last, last_u,
        last_ctx, last_msk, last_yd, last_yt)."""
        c = self.carry
        for name, field in (("toks", "last"), ("us", "last_u"),
                            ("chs", "last_ctx"), ("msk", "last_msk"),
                            ("yd", "last_yd"), ("yt", "last_yt")):
            c[name][b] = 0
            c[name][b, 0] = first[field][0]
        c["fd"][b] = 0
        eos0 = first["last"][0] == (-1 if self.eos_id is None
                                    else self.eos_id)
        c["lens"][b] = 1
        c["eos"][b] = eos0
        c["done"][b] = eos0 | (n_tok_b <= 1)
        for name in ("total", "acc_total", "alive_steps"):
            c[name][b] = 0

    def _admit_dense(self, sub: Dict[str, Any], b: int, n_tok_b: int):
        """Scatter a batch-1 engine state into row ``b`` of the live state
        (in place; caches carry their batch dim at axis 1, ``pos`` at axis
        0; the scalar ``step_idx`` is shared) and arm its buffers."""
        state = self.carry["state"]
        for k, v in state.items():
            if k in ("t_cache", "d_cache"):
                for ck, cv in v.items():
                    if ck == "pos":
                        cv[b] = sub[k][ck][0]
                    else:
                        cv[:, b] = sub[k][ck][:, 0].to(cv.dtype)
            elif isinstance(v, torch.Tensor):
                v[b] = sub[k][0]
        self._arm_buffers(b, sub, n_tok_b)

    def _resolve_key(self, req: Request, b: int) -> None:
        """Assign the request's serving key word and strength γ to slot
        ``b``: an explicit ``Request.key``, the pool's least-loaded active
        word, or the scheduler default; a ``tier`` goes through the
        strength controller (γ = 1 without one).  The tier resolves (and
        may raise, on an unknown tier or a missing controller) before any
        pool reference is taken, so a failure leaves the scheduler as it
        was."""
        gamma = 1.0
        if req.tier is not None:
            if self.strength_controller is None:
                raise ValueError(
                    f"request uid={req.uid} names strength tier "
                    f"{req.tier!r} but the scheduler was built without a "
                    "strength_controller")
            gamma = float(self.strength_controller.pick(req.tier))
        pooled = False
        if self.key_pool is not None:
            word = self.key_pool.acquire(req.key)
            pooled = True
        elif req.key is not None:
            word = _word_of(req.key)
        else:
            word = self.key_word
        self._slot_key[b] = word
        self._slot_strength[b] = gamma
        self._slot_tier[b] = req.tier
        self._slot_pooled[b] = pooled

    def _admit(self) -> int:
        """Fill every FREE slot from the queue head (FIFO); returns the
        number of admissions."""
        if self.paged:
            return self._admit_paged()
        n = 0
        for b, slot in enumerate(self.slots):
            if not self.queue:
                break
            if slot.phase != FREE:
                continue
            req = self.queue[0]
            self._resolve_key(req, b)
            self.queue.popleft()
            slot.phase, slot.request = PREFILLING, req
            prompt = torch.as_tensor(req.prompt[None], dtype=torch.int64,
                                     device=self.dev)
            r = self._row(b)
            if r is not None:
                sub = E.init_state(self.t_model, self.d_model, self.scfg,
                                   prompt, self.max_seq, self._slot_key[b],
                                   strength=self._slot_strength[b])
                self._admit_dense(sub, r, req.n_tokens)
            elif self._peers:
                # init_state's model calls, on zero rows
                self.t_model.prefill(prompt[:0], self.max_seq)
                self._drafter.prefill(self.d_model, prompt[:0], self.max_seq)
            self.n_tok[b] = req.n_tokens
            slot.phase = DECODING
            self._streamed[b] = 0
            self._done_host[b] = False
            self.admit_order.append(req.uid)
            n += 1
        return n

    # -- paged admission: page tables + chunked prefill --------------------

    def _table_row(self, b: int) -> torch.Tensor:
        """Slot ``b``'s table row (its pages, then null-page padding)."""
        row = np.zeros((self.max_pages,), np.int64)
        pages = self._slot_pages[b]
        row[:len(pages)] = pages
        return torch.as_tensor(row, device=self.dev)

    def _set_table(self, b: int) -> None:
        """Write slot ``b``'s table row into both caches, where this rank
        holds the slot: the two models' ``pos`` advance in lockstep, so
        one logical allocation serves both pools.  A recurrent draft's
        dense cache has no table."""
        r = self._row(b)
        if r is None:
            return
        row = self._table_row(b)
        state = self.carry["state"]
        for cn in ("t_cache", "d_cache"):
            if "page_table" in state[cn]:
                state[cn]["page_table"][r] = row

    def _chunk(self, toks: torch.Tensor, b: int, start_pos: int,
               new_pos: int) -> torch.Tensor:
        """One prompt chunk through both models' paged ``extend_step`` for
        slot ``b`` -> target logits (1, ck, V).  A rank that does not hold
        the slot writes the chunk into its copy of the pool all the same
        (through the slot's table row), and runs a recurrent draft's state
        on zero rows where its peers need the call."""
        state = self.carry["state"]
        r = self._row(b)
        table = self._table_row(b)[None] if r is None else None
        t_logits, t_cache = paged_slot_extend(
            self.t_model, toks, state["t_cache"], r, start_pos, new_pos,
            table)
        d_cache = state["d_cache"]
        if r is not None or self._drafter.paged_cache or self._peers:
            _, d_cache = self._drafter.slot_extend(
                self.d_model, toks, d_cache, r, start_pos, new_pos, table)
        self.carry["state"] = dict(state, t_cache=t_cache, d_cache=d_cache)
        return t_logits

    def _finalize(self, b: int, logits: torch.Tensor, last_idx: int,
                  window_row: np.ndarray, n_tok_b: int) -> None:
        """Sample slot ``b``'s prefill token from its last prompt-position
        logits and arm the slot — the paged counterpart of the dense
        admission, through ``engine.first_token_meta`` as ``init_state``
        does (on the rank that holds the slot).  The slot's key word and
        strength land in the state's rows here."""
        r = self._row(b)
        if r is None:
            return
        state = self.carry["state"]
        dev = self.dev
        key_word, strength = self._slot_key[b], self._slot_strength[b]
        meta = E.first_token_meta(
            self._dec, self.scfg,
            torch.tensor([key_word], dtype=torch.int64, device=dev),
            logits[:, last_idx],
            torch.as_tensor(window_row[None], device=dev), self.tcfg.vocab,
            torch.tensor([strength], dtype=torch.float32, device=dev))
        gated0 = meta["last_msk"][0]
        state["keys"][r] = key_word
        state["strength"][r] = strength
        for k in ("window", "last", "last_ctx", "last_u", "last_msk",
                  "last_yd", "last_yt"):
            state[k][r] = meta[k][0]
        state["n_committed"][r] = state["t_cache"]["pos"][r] + 1
        state["hist"][r] = 0
        state["hist"][r, 0] = torch.where(gated0, 0, meta["last_ctx"][0])
        state["hist_n"][r] = (~gated0).to(torch.int64)
        self._arm_buffers(r, meta, n_tok_b)

    def _admit_paged(self) -> int:
        """Reserve pages and page tables for queued prompts (FIFO, with
        head-of-line blocking on pool space) and mark their slots
        PREFILLING; the prompt tokens stream in through ``_prefill_step``,
        one chunk per sync round.  With a prefix cache, every hit page of
        the prompt's full-page prefix chain is ``share``d into the slot's
        table (no prefill work) and only the uncached tail allocates and
        prefills, from the cached-token offset.  Under pool pressure the
        cache evicts LRU cache-only entries (the hit chain is protected)
        before admission waits.  ``_resolve_key`` (which can raise) runs
        before any page is taken or any slot state is touched."""
        n = 0
        for b, slot in enumerate(self.slots):
            if not self.queue:
                break
            if slot.phase != FREE:
                continue
            req = self.queue[0]
            total = -(-len(req.prompt) // self.page_size)
            if self._prefix is not None:
                digests, shared = self._prefix.lookup(req.prompt)
            else:
                digests, shared = [], []
            need = total - len(shared)
            if need > self._alloc.n_free and self._prefix is not None:
                self._prefix.evict(need - self._alloc.n_free,
                                   protect=set(digests))
            if need > self._alloc.n_free:
                break
            self._resolve_key(req, b)      # may raise: nothing held yet
            self.queue.popleft()
            for p in shared:
                self._alloc.share(p)
            self._slot_pages[b] = list(shared) + self._alloc.alloc(need)
            self._slot_hit_digests[b] = list(digests)
            self._prefill_base[b] = len(shared) * self.page_size
            self._set_table(b)
            slot.phase, slot.request = PREFILLING, req
            self._chunk_cursor[b] = 0
            if shared:
                self._prefix.pages_saved += len(shared)
                self.events.append(
                    ("admit_shared", req.uid, int(self._prefill_base[b])))
            n += 1
        return n

    def _prefill_step(self) -> None:
        """Advance every PREFILLING slot by ONE prompt chunk (a long prompt
        yields to the decode loop between chunks); the slot's last chunk
        also runs the finalize and flips it to DECODING."""
        for b, slot in enumerate(self.slots):
            if slot.phase != PREFILLING:
                continue
            req = slot.request
            S0, ck = len(req.prompt), self.prefill_chunk
            i = int(self._chunk_cursor[b])
            # chunk i covers prompt[base + i*ck : base + (i+1)*ck]; prefix
            # hits keep base <= S0 - 1, so every slot prefills >= 1 token
            start = int(self._prefill_base[b]) + i * ck
            chunk = np.zeros((ck,), np.int64)
            chunk[:min(ck, S0 - start)] = req.prompt[start:start + ck]
            new_pos = min(start + ck, S0)
            logits = self._chunk(torch.as_tensor(chunk, device=self.dev), b,
                                 start, new_pos)
            self.events.append(("admit_chunk", req.uid, i))
            self._chunk_cursor[b] = i + 1
            if new_pos < S0:
                continue
            c = self.scfg.ctx_window
            window = np.zeros((c,), np.int64)
            window[max(c - S0, 0):] = req.prompt[-c:]
            self._finalize(b, logits, S0 - 1 - start, window, req.n_tokens)
            self.n_tok[b] = req.n_tokens
            slot.phase = DECODING
            self._streamed[b] = 0
            # finalize leaves pos at the host-known S0
            self._pos_host[b] = S0
            self._done_host[b] = False
            self.admit_order.append(req.uid)
            self.events.append(("finalize", req.uid))
            if self._prefix is not None:
                # the share-eligible blocks are fully written: hand the new
                # full-prefix pages to the cache (it takes its own refs)
                self._prefix.insert_chain(req.prompt,
                                          self._slot_hit_digests[b],
                                          self._slot_pages[b])

    def _ensure_pages(self) -> None:
        """Grow every live DECODING slot's pages to cover the next decode
        chunk's write horizon (pos can advance ``sync_every * (K+1)`` and
        each step writes ``K`` ahead), planned from the host mirrors of
        the last snapshot.  Under ``overlap`` that snapshot lags one chunk,
        so the horizon covers two chunks of advance (a slot that finished
        in flight may grow a page the flush frees one round later).
        Mid-request pool exhaustion raises."""
        if not any(s.phase == DECODING for s in self.slots):
            return
        K1 = self.scfg.K + 1
        chunks_ahead = 2 if self.overlap else 1
        for b, slot in enumerate(self.slots):
            if slot.phase != DECODING or bool(self._done_host[b]):
                continue
            horizon = int(self._pos_host[b]) + (
                chunks_ahead * self.sync_every + 1) * K1
            need = min(-(-horizon // self.page_size), self.max_pages)
            grow = need - len(self._slot_pages[b])
            if grow <= 0:
                continue
            if grow > self._alloc.n_free and self._prefix is not None:
                # growing a live slot outranks keeping cold prefixes warm
                self._prefix.evict(grow - self._alloc.n_free)
            try:
                self._slot_pages[b].extend(self._alloc.alloc(grow))
            except RuntimeError as e:
                raise RuntimeError(
                    f"KV page pool exhausted growing live slot {b} "
                    f"(uid={slot.request.uid}, pos={int(self._pos_host[b])})"
                    f": {e}. Mid-request eviction is unsupported — raise "
                    "num_pages to cover the worst-case live footprint."
                ) from e
            self._set_table(b)

    # -- decode chunk and sync-point snapshot ------------------------------

    def _run_chunk(self) -> None:
        """Advance the loop by up to ``sync_every`` steps (it stops earlier
        when every live slot drains)."""
        n_tok = torch.as_tensor(self.n_tok[self._rows], device=self.dev)
        self.carry = self._loop(self.t_model, self.d_model, self.carry,
                                n_tok, self.eos_id,
                                self.carry["n_steps"] + self.sync_every)

    _ROW_KEYS = ("toks", "fd", "us", "chs", "msk", "yd", "yt")
    _FLAG_KEYS = ("done", "eos", "lens", "total", "acc_total",
                  "alive_steps")

    def _snap_handles(self, carry) -> Dict[str, Any]:
        """Enqueue one sync round's host view without waiting: this rank's
        flags (and paged ``pos``) and the full buffer rows of every
        DECODING slot it holds, gathered on the device (a copy: the loop
        writes the buffers in place) and copied into pinned host tensors,
        then one event after those copies (``_host_copy``).  Under
        ``overlap`` this runs before the decode chunk, so ``device_get``
        never waits on it."""
        flags = {k: carry[k] for k in self._FLAG_KEYS}
        if self.paged:
            flags["pos"] = carry["state"]["t_cache"]["pos"]
        live = [b for b, s in enumerate(self.slots)
                if s.phase == DECODING and self._row(b) is not None]
        rows = {}
        if live:
            idx = torch.tensor([self._row(b) for b in live],
                               dtype=torch.int64,
                               pin_memory=self.dev.type == "cuda")
            idx = idx.to(self.dev, non_blocking=True)
            rows = {k: carry[k].index_select(0, idx) for k in self._ROW_KEYS}
        return _host_copy({"flags": flags, "rows": rows, "live": live})

    def _take_snapshot(self, handles) -> Dict[str, Any]:
        """The round's one transfer (``device_get``), gathered over dp to
        the whole batch's view (one all-gather) on a sharded batch;
        refreshes the host mirrors ``_ensure_pages`` plans from."""
        snap = device_get(handles)
        if self._dp:
            got = self.layout.gather_rows(
                {**snap["flags"], "rows": snap["rows"]}, self._dp)
            rows = got.pop("rows")
            snap = {"flags": got, "rows": rows}
        flags = snap["flags"]
        if self.paged:
            self._pos_host[:] = flags["pos"]
        self._done_host[:] = flags["done"]
        return snap

    def _stream_events(self, snap, t_now: float
                       ) -> Iterator[Tuple[int, int, dict]]:
        """Surface every token the snapshot newly committed, in slot
        order: record its visibility time, fire ``on_token`` and yield
        ``(uid, token, meta)``.  Runs before ``_flush`` on the same
        snapshot, so a request's last token streams before its result
        exists."""
        flags = snap["flags"]
        for b, slot in enumerate(self.slots):
            if slot.phase != DECODING or b not in snap["rows"]:
                continue
            n = int(flags["lens"][b])
            start = int(self._streamed[b])
            if n <= start:
                continue
            uid = slot.request.uid
            toks = snap["rows"][b]["toks"]
            done = bool(flags["done"][b])
            t_rel = t_now - self._t_submit[uid]
            arr = self._arrivals.setdefault(uid, [])
            for i in range(start, n):
                arr.append(t_rel)
                meta = {"index": i, "round": self.n_rounds,
                        "t_rel_s": t_rel,
                        "final": done and i == n - 1}
                if self.on_token is not None:
                    self.on_token(uid, int(toks[i]), meta)
                yield (uid, int(toks[i]), meta)
            self._streamed[b] = n

    # -- flush (sync point) ------------------------------------------------

    def _flush(self, snap) -> List[RequestResult]:
        """Collect every DECODING slot whose ``done`` flag is set in the
        round's snapshot: trim its rows, build the RequestResult, free the
        slot (no device transfer: the rows came with the snapshot; under
        ``overlap`` a slot finishing inside the in-flight chunk flushes a
        round later, from rows the loop has frozen).  A paged slot drops
        its page references and its table row is nulled: the freed slot
        keeps riding the loop done-masked, and its frozen writes must land
        in the null page, not in pages that may be reallocated to a new
        request."""
        flags = snap["flags"]
        out: List[RequestResult] = []
        for b, slot in enumerate(self.slots):
            if slot.phase != DECODING or not bool(flags["done"][b]):
                continue
            slot.phase = DRAINED
            n = int(flags["lens"][b])
            # copies: a result must not hold the round's pinned buffers
            row = {k: v[:n].copy() for k, v in snap["rows"][b].items()}
            req = slot.request
            arrivals = np.asarray(self._arrivals.pop(req.uid, []),
                                  np.float64)
            res = RequestResult(
                uid=req.uid, tokens=row["toks"].astype(np.int32),
                src=row["fd"], u=row["us"],
                ctx_hashes=row["chs"].astype(np.uint32),
                masked=row["msk"], length=n,
                eos=bool(flags["eos"][b]),
                ttft_s=float(arrivals[0]) if len(arrivals) else None,
                arrivals_s=arrivals if len(arrivals) else None,
                alive_steps=int(flags["alive_steps"][b]),
                n_accepted=int(flags["acc_total"][b]),
                n_emitted=int(flags["total"][b]),
                y_draft=row["yd"], y_target=row["yt"],
                stat_scheme=self._stat_scheme,
                key_word=self._slot_key[b],
                strength=self._slot_strength[b],
                tier=self._slot_tier[b])
            self._acc += res.n_accepted
            self._emitted += res.n_emitted
            self._alive += res.alive_steps
            self.results[req.uid] = res
            out.append(res)
            slot.phase, slot.request = FREE, None
            self.n_tok[b] = 0
            self._streamed[b] = 0
            self._pos_host[b] = 0
            self._done_host[b] = False
            if self.on_result is not None:
                self.on_result(res)
            if self._slot_pooled[b]:
                self.key_pool.release(self._slot_key[b])
                self._slot_pooled[b] = False
            self._slot_key[b] = self.key_word
            self._slot_strength[b] = 1.0
            self._slot_tier[b] = None
            if self.paged:
                # ``free`` decrements: private pages return to the pool,
                # prefix-shared pages survive under the remaining refs
                self._alloc.free(self._slot_pages[b])
                self._slot_pages[b] = []
                self._slot_hit_digests[b] = []
                self._prefill_base[b] = 0
                self._set_table(b)
                self.events.append(("flush", req.uid))
        return out

    # -- drive -------------------------------------------------------------

    def _active(self) -> bool:
        return any(s.phase != FREE for s in self.slots)

    def run_stream(self) -> Iterator[Tuple[int, int, dict]]:
        """Drain the queue, yielding ``(uid, token, meta)`` as tokens
        surface at sync points; results land in ``self.results`` as slots
        flush (``meta``: the token's ``index`` in its request, the sync
        ``round``, the visibility time ``t_rel_s`` after submit, and
        ``final`` on a request's last token).  Per round: a prefill chunk
        for every PREFILLING slot (paged), page growth, a decode chunk,
        then the host work — one transfer, streaming, flush, admission.
        With ``overlap`` the transfer's copies are enqueued before the
        chunk (its input), so its wait never includes the chunk; without
        it they follow the chunk (its output)."""
        # every round flushes a request, admits a prompt chunk or advances
        # >= 1 committed token on some live slot, so this bound is reached
        # only if the scheduler deadlocks; under overlap each flush wave
        # trails the chunk that finished it by one round
        limit = 4 + 2 * len(self.queue) + self._total_target
        if self.overlap:
            limit += 1 + len(self.queue)
        if self.paged:
            limit += self._total_chunks
        rounds = 0
        self._admit()
        self._check_paged_deadlock()
        while self.queue or self._active():
            rounds += 1
            self.n_rounds = rounds
            if rounds > limit:
                raise RuntimeError(
                    f"scheduler stalled after {rounds} sync rounds "
                    f"(queue={len(self.queue)}, "
                    f"slots={[s.phase for s in self.slots]})")
            if self.paged:
                self._prefill_step()
                self._ensure_pages()
            if self.overlap:
                handles = self._snap_handles(self.carry)
                self._run_chunk()
            else:
                self._run_chunk()
                handles = self._snap_handles(self.carry)
            snap = self._take_snapshot(handles)
            yield from self._stream_events(snap, time.perf_counter())
            self._flush(snap)
            self._admit()
            self._check_paged_deadlock()

    def run(self) -> List[RequestResult]:
        """Drain the queue: admit → decode chunk → flush, until every
        request completed.  Returns results in uid order."""
        for _ in self.run_stream():
            pass
        return [self.results[uid] for uid in sorted(self.results)]

    def _check_paged_deadlock(self) -> None:
        """Every slot idle and a queue that admission skipped means the
        head prompt alone overflows the pool: waiting can never help."""
        if not (self.paged and self.queue) or self._active():
            return
        req = self.queue[0]
        need = -(-len(req.prompt) // self.page_size)
        cached = ""
        if self._prefix is not None:
            _, shared = self._prefix.lookup(req.prompt)
            need -= len(shared)
            cached = (f" ({len(shared)} prefix pages cached, "
                      f"{self._prefix.pages_held} held by the cache)")
        raise RuntimeError(
            f"KV page pool too small: request uid={req.uid} needs {need} "
            f"pages for its {len(req.prompt)}-token prompt but only "
            f"{self._alloc.n_free} of {self.num_pages - 1} allocatable "
            f"pages exist (every slot idle){cached} — raise num_pages")

    def stats(self) -> Dict[str, float]:
        """Cumulative serving stats over flushed requests (drained slots
        never count toward the denominators).  Beside the reference's keys:
        ``spec_steps`` (batched spec steps run), ``sync_rounds`` and, paged,
        ``prefill_chunks``."""
        denom = max(self._alive, 1)
        out = {"served": float(len(self.results)),
               "aatps": self._acc / denom,
               "tokens_per_step": self._emitted / denom,
               "alive_slot_steps": float(self._alive),
               "spec_steps": float(self.carry["n_steps"]),
               "sync_rounds": float(self.n_rounds)}
        ttfts = [r.ttft_s for r in self.results.values()
                 if r.ttft_s is not None]
        if ttfts:
            out["ttft_mean_s"] = float(np.mean(ttfts))
        gaps = [r.gaps_s for r in self.results.values()
                if r.gaps_s is not None]
        if gaps:
            allg = np.concatenate(gaps)
            out["gap_mean_s"] = float(allg.mean())
            out["gap_p95_s"] = float(np.percentile(allg, 95))
        if self.paged:
            out["prefill_chunks"] = float(sum(e[0] == "admit_chunk"
                                              for e in self.events))
            out["pages_used"] = float(self._alloc.n_used)
            out["pages_free"] = float(self._alloc.n_free)
            out["pages_peak"] = float(self._alloc.n_used_peak)
            if self._prefix is not None:
                out["prefix_entries"] = float(self._prefix.n_entries)
                out["prefix_pages"] = float(self._prefix.pages_held)
                out["prefix_hits"] = float(self._prefix.hits)
                out["prefix_misses"] = float(self._prefix.misses)
                out["prefix_evictions"] = float(self._prefix.evictions)
                out["prefix_pages_saved"] = float(self._prefix.pages_saved)
        return out
