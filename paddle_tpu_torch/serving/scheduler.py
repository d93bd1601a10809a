"""Iteration-level (continuous) batching over a GenerationEngine.

Counterpart of `paddle_tpu/serving/scheduler.py`:

  submit() -> bounded admission queue (QueueFullError past the cap)
  step()   -> apply queued weight swaps, retire finished slots
              (max_new_tokens / eos), refill free slots from the queue by
              (priority, arrival), grow paged slots' block tables —
              preempting a victim under allocation pressure — then advance
              every occupied slot one token, or one speculative round
              (`engine.decode_many`) of 1..gamma+1 tokens
  drain()  -> stop admitting, run until in-flight work finishes

Preemption is recompute-style: the victim's blocks go back to the pool and
it is requeued with prompt + tokens-so-far as its restart prompt, so its
delivered stream continues unchanged (bit-identically under greedy
decoding).

Staged placement: a request may arrive with its prefill already computed
elsewhere (`submit(staged_kv=...)`, a KV bundle the engine adopts instead
of prefilling) or with a prefix chain shipped from another engine
(`submit(staged_prefix=...)`, restored into the local prefix cache before
the request's own prefill). A bundle that cannot be used degrades to a
local prefill; preemption drops it.

Left out of this port: request deadlines (timeouts and slack-ordered
victims), load shedding, decode-failure quarantine (an engine exception
propagates), adapter swaps, decode capture, the metrics registry, the
decision, timeline and KV-ledger records, the chaos sites, rate limits and
tenancy (a request's `prefix_namespace` is passed through to the engine)
and cancellation.
"""
import collections
import itertools
import threading
import time

import numpy as np

from ..core.device import resolve_device
from .blocks import BlockAllocError

__all__ = ["ServingConfig", "Scheduler", "Request", "RequestHandle",
           "QueueFullError", "PRIORITIES"]

QUEUED = "QUEUED"
RUNNING = "RUNNING"
DONE = "DONE"
REJECTED = "REJECTED"

# SLO priority classes, lower is better. Preemption victims are picked
# worst class first, earliest slot first within a class.
PRIORITIES = {"interactive": 0, "standard": 1, "batch": 2}


class QueueFullError(RuntimeError):
    """Admission queue at capacity (or draining): retry later."""


class ServingConfig:
    def __init__(self, max_queue=64, default_max_new_tokens=32):
        self.max_queue = int(max_queue)
        self.default_max_new_tokens = int(default_max_new_tokens)


class Request:
    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens, submitted_at, priority=1,
                 rng_seed=0, rng_gen=0):
        self.id = next(Request._ids)
        self.prompt = list(prompt)        # the original prompt
        self.max_new_tokens = max_new_tokens
        self.submitted_at = submitted_at
        self.priority = int(priority)
        self.rng_seed = rng_seed
        self.rng_gen = int(rng_gen)
        self.status = QUEUED
        self.tokens = []                  # generated tokens, stream order
        self.slot = None
        self.preempted = 0                # times evicted and requeued
        self.prefix_hit = False           # prefill reused cached blocks
        self.spec_proposed = 0            # draft tokens proposed for us
        self.spec_accepted = 0            # ... and accepted by verify
        self.adopted = False              # placed from a staged KV bundle
        self.kv_restored_tokens = 0       # tokens a staged prefix restored
        self.prefix_namespace = None      # prefix-cache namespace
        self._staged = None               # (ks, vs, plen, first[, rng])
        self._staged_prefix = None        # (ks, vs, plen, namespace)
        self._exec_prompt = None          # restart prompt after preemption
        self.first_token_at = None
        self.finished_at = None
        self._done = threading.Event()

    @property
    def exec_prompt(self):
        """What prefill runs: the prompt, or after a preemption prompt +
        everything generated so far."""
        return self._exec_prompt if self._exec_prompt is not None \
            else self.prompt

    def finished(self, eos_token_id):
        """The stop rule: max_new_tokens reached or eos emitted."""
        return (len(self.tokens) >= self.max_new_tokens
                or (eos_token_id is not None and bool(self.tokens)
                    and self.tokens[-1] == eos_token_id))


class RequestHandle:
    """Caller-facing view of one request: an append-only token stream and
    a terminal status."""

    def __init__(self, req):
        self._req = req

    @property
    def request_id(self):
        return self._req.id

    @property
    def status(self):
        return self._req.status

    @property
    def tokens(self):
        return list(self._req.tokens)

    @property
    def priority(self):
        return self._req.priority

    @property
    def preempted(self):
        return self._req.preempted

    @property
    def prefix_hit(self):
        return self._req.prefix_hit

    @property
    def spec_proposed(self):
        """Draft tokens proposed for this request (speculative engines)."""
        return self._req.spec_proposed

    @property
    def spec_accepted(self):
        return self._req.spec_accepted

    @property
    def adopted(self):
        """Placed by adopting its staged KV bundle (no local prefill)."""
        return self._req.adopted

    @property
    def kv_restored_tokens(self):
        """Prefix tokens its staged prefix chain restored (0 if none)."""
        return self._req.kv_restored_tokens

    def done(self):
        return self._req.status in (DONE, REJECTED)

    def result(self, timeout=None):
        """Block until terminal; returns the token list."""
        if not self._req._done.wait(timeout):
            raise TimeoutError(f"request {self._req.id} still "
                               f"{self._req.status}")
        return self.tokens

    @property
    def ttft_s(self):
        r = self._req
        if r.first_token_at is None:
            return None
        return r.first_token_at - r.submitted_at


class Scheduler:
    """Continuous batching over `engine`. `device` (default "cuda") must
    be the engine's device: without CUDA it raises unless "cpu" is
    passed, like every entry point of the port."""

    def __init__(self, engine, config=None, clock=time.monotonic,
                 device="cuda", **kwargs):
        dev = resolve_device(device)
        if engine.device != dev:
            raise ValueError(f"engine runs on {engine.device}, scheduler "
                             f"device is {dev}")
        self.engine = engine
        self.config = config or ServingConfig(**kwargs)
        self._clock = clock
        self._queue = collections.deque()
        self._slots = [None] * engine.slots   # Request or None
        self._draining = False
        self._steps = 0
        self._tokens = 0                      # every token delivered
        self._decode_tokens = 0               # ... of them by decode steps
        self._decode_steps = 0
        self._decode_time_s = 0.0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._completed = []
        self.counts = dict.fromkeys(
            ("admitted", "done", "rejected", "preempted", "adopted"), 0)
        self._pending_swaps = collections.deque()   # armed hot-swaps
        self.last_swap = None                 # apply_pending_swap summary
        self.model_version = None

    # -- admission -----------------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, priority="standard",
               rng_seed=None, rng_gen=0, staged_kv=None, staged_prefix=None,
               prefix_namespace=None):
        """Queue one request; returns its RequestHandle. `rng_seed` pins
        the sampler stream (None derives one from the engine seed and the
        request id).

        `staged_kv=(ks, vs, plen, first_token[, rng])` places the request
        from a KV bundle another engine prefilled (`engine.adopt_kv`)
        instead of a local prefill. `prompt` must still be the full
        prompt: it is what a preemption recomputes, and the bundle is kept
        only when `plen == len(prompt)` (and the engine can adopt). The
        optional 5th element is a v3 bundle's (seed, gen) sampler state.
        `staged_prefix=(ks, vs, plen, namespace)` is a prefix chain shipped
        from another engine: at placement it is restored into the local
        prefix cache (`engine.restore_prefix`) so the request's own
        prefill matches it; a restore that fails restores nothing.
        `prefix_namespace` keys the request's prefix-cache blocks."""
        prompt = [int(t) for t in prompt]
        now = self._clock()
        max_new = self.config.default_max_new_tokens \
            if max_new_tokens is None else int(max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        prio = PRIORITIES.get(priority, priority)
        if not isinstance(prio, int):
            raise ValueError(f"unknown priority {priority!r}; want one of "
                             f"{sorted(PRIORITIES)} or an int class")
        req = Request(prompt, max_new, now, priority=prio, rng_gen=rng_gen)
        req.rng_seed = rng_seed if rng_seed is not None else \
            (self.engine.config.seed * 1000003 + req.id * 7919 + 1) \
            & 0x7FFFFFFF
        handle = RequestHandle(req)
        if self._draining:
            self._finish(req, REJECTED)
            raise QueueFullError("scheduler is draining")
        if len(self._queue) >= self.config.max_queue:
            self._finish(req, REJECTED)
            raise QueueFullError(
                f"admission queue full ({self.config.max_queue})")
        if not prompt:
            self._finish(req, REJECTED)
            raise ValueError("empty prompt")
        if len(prompt) > self.engine.max_prompt_len or \
                len(prompt) + max_new > self.engine.config.max_len:
            self._finish(req, REJECTED)
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new}) "
                f"exceeds the engine limits (max prompt "
                f"{self.engine.max_prompt_len}, cache max_len "
                f"{self.engine.config.max_len})")
        if staged_kv is not None and hasattr(self.engine, "adopt_kv") \
                and int(staged_kv[2]) == len(prompt):
            req._staged = staged_kv
        if staged_prefix is not None \
                and hasattr(self.engine, "restore_prefix"):
            req._staged_prefix = staged_prefix
        req.prefix_namespace = prefix_namespace
        self._queue.append(req)
        self.counts["admitted"] += 1
        return handle

    # -- weight hot-swap ------------------------------------------------------
    def schedule_weight_swap(self, params, version=None):
        """Arm a weight hot-swap: `params` ({name: tensor or array})
        replaces the engine's serving weights at the top of the next step,
        between decode steps, so every token is computed under one weight
        set. Swaps armed back to back apply in arrival order. Returns a
        threading.Event set once the swap was applied or refused; its
        `swap_result` holds that swap's outcome (`last_swap` holds the
        latest). A refused swap keeps the old weights serving."""
        ev = threading.Event()
        self._pending_swaps.append({"params": params, "version": version,
                                    "event": ev})
        return ev

    def apply_pending_swap(self):
        """Apply every armed swap now, in arrival order (step() calls it
        first). Returns True when at least one swap was processed."""
        applied = False
        while self._pending_swaps:
            swap = self._pending_swaps.popleft()
            applied = True
            try:
                n = self.engine.swap_params(swap["params"])
            except (ValueError, TypeError, RuntimeError) as e:
                self.last_swap = {"ok": False, "version": swap["version"],
                                  "error": f"{type(e).__name__}: {e}"}
            else:
                if swap["version"] is not None:
                    self.model_version = swap["version"]
                self.last_swap = {"ok": True, "version": swap["version"],
                                  "params": n,
                                  "inflight": self.active_slots()}
            swap["event"].swap_result = dict(self.last_swap)
            swap["event"].set()
        return applied

    # -- the iteration loop ----------------------------------------------------
    def step(self):
        """One scheduling iteration. Returns True while work remains."""
        self.apply_pending_swap()
        self._retire()
        self._refill()
        self._grow_paged_slots()
        if any(r is not None for r in self._slots):
            t0 = self._clock()
            # a speculative engine advances each slot by a verify window
            # a round; every other engine by a 1-wide window
            decode_many = getattr(self.engine, "decode_many", None)
            if decode_many is not None:
                toks, counts = decode_many()
            else:
                toks = np.asarray(self.engine.decode()).reshape(-1, 1)
                counts = np.ones((toks.shape[0],), np.int32)
            self._decode_time_s += self._clock() - t0
            self._decode_steps += 1
            proposed = toks.shape[1] - 1         # gamma for spec, else 0
            eos = self.engine.config.eos_token_id
            for slot, req in enumerate(self._slots):
                if req is None:
                    continue
                if proposed:
                    accepted = int(counts[slot]) - 1
                    req.spec_proposed += proposed
                    req.spec_accepted += accepted
                    self._spec_proposed += proposed
                    self._spec_accepted += accepted
                # the slot's emitted run, cut where the one-token loop
                # would have stopped (eos / max_new_tokens)
                for j in range(int(counts[slot])):
                    req.tokens.append(int(toks[slot, j]))
                    self._tokens += 1
                    self._decode_tokens += 1
                    if req.finished(eos):
                        break
        self._steps += 1
        return bool(self._queue or any(s is not None for s in self._slots))

    def active_slots(self):
        return sum(1 for s in self._slots if s is not None)

    def drain(self, max_steps=100000):
        """Stop admitting and finish what is in flight."""
        self._draining = True
        self.run_until_idle(max_steps)

    def run_until_idle(self, max_steps=100000):
        for _ in range(max_steps):
            if not self.step():
                return

    # -- preemption ------------------------------------------------------------
    def _pick_victim(self, worse_than=None, exclude=()):
        """Worst priority class first, earliest slot on ties; only classes
        strictly worse than `worse_than` when given."""
        best = None
        for slot, req in enumerate(self._slots):
            if req is None or slot in exclude:
                continue
            if worse_than is not None and req.priority <= worse_than:
                continue
            if best is None or req.priority > self._slots[best].priority:
                best = slot
        return best

    def _preempt(self, slot):
        """Evict `slot`'s request, freeing its blocks, and requeue it with
        prompt + tokens-so-far as its restart prompt."""
        req = self._slots[slot]
        self.engine.reset_slot(slot)
        self._slots[slot] = None
        req.slot = None
        req.preempted += 1
        self.counts["preempted"] += 1
        remaining = req.max_new_tokens - len(req.tokens)
        if remaining < 1:                  # raced its own completion
            self._finish(req, DONE)
            return
        resume = req.prompt + req.tokens
        if len(resume) > self.engine.max_prompt_len:
            raise RuntimeError(
                f"request {req.id}: restart prompt ({len(resume)} tokens) "
                f"exceeds the engine's longest prompt")
        req._exec_prompt = resume
        req._staged = None                 # evicted KV is gone: recompute
        req.status = QUEUED
        self._queue.append(req)            # keeps its arrival order

    def _grow_paged_slots(self):
        """Before the step every occupied slot must own the block its next
        token lands in. Pressure preempts among the growing request's
        class and worse, the growing slot included."""
        ensure = getattr(self.engine, "ensure_slot_capacity", None)
        if ensure is None:
            return
        for slot in range(len(self._slots)):
            req = self._slots[slot]
            while req is not None and self._slots[slot] is req:
                try:
                    ensure(slot)
                    break
                except BlockAllocError:
                    victim = self._pick_victim(worse_than=req.priority - 1)
                    self._preempt(slot if victim is None else victim)

    # -- phases ------------------------------------------------------------------
    def _retire(self):
        eos = self.engine.config.eos_token_id
        for slot, req in enumerate(self._slots):
            if req is not None and req.finished(eos):
                self.engine.reset_slot(slot)
                self._slots[slot] = None
                self._finish(req, DONE)

    def _pop_next(self):
        """Best queued request by (priority class, arrival)."""
        if not self._queue:
            return None
        best = min(self._queue, key=lambda r: (r.priority, r.id))
        self._queue.remove(best)
        return best

    def _refill(self):
        for slot in range(len(self._slots)):
            # a request that completes at prefill retires at once and
            # frees the slot for the next one
            while self._slots[slot] is None:
                req = self._pop_next()
                if req is None:
                    return
                if not self._try_place(slot, req):
                    return

    def _try_place(self, slot, req):
        """Prefill `req` into `slot`. Allocation pressure preempts a
        strictly worse-class victim and retries; with none, the request is
        requeued and refill stops for this step (returns False)."""
        while True:
            try:
                first = self._place_once(slot, req)
                break
            except BlockAllocError:
                victim = self._pick_victim(worse_than=req.priority,
                                           exclude=(slot,))
                if victim is None:
                    self._queue.append(req)
                    return False
                self._preempt(victim)
        req.slot = slot
        req.status = RUNNING
        if req.first_token_at is None:
            req.first_token_at = self._clock()
        stats = getattr(self.engine, "last_prefill_stats", None) or {}
        if stats.get("prefix_hit_tokens", 0) > 0:
            req.prefix_hit = True
        req.tokens.append(first)
        self._tokens += 1
        if req.finished(self.engine.config.eos_token_id):
            self.engine.reset_slot(slot)
            self._finish(req, DONE)
        else:
            self._slots[slot] = req
        return True

    def _place_once(self, slot, req):
        """One placement attempt: adopt the staged KV bundle when the
        request carries one, else (after restoring a staged prefix chain)
        a local prefill. A bundle that fails adoption for any reason but
        allocation pressure is dropped and the attempt falls back to a
        local prefill in place; BlockAllocError escapes (the caller
        preempts)."""
        staged = req._staged
        if staged is None:
            self._restore_staged_prefix(req)
            return self._prefill(slot, req)
        try:
            # an rng-less (v1/v2) bundle arms the request's own stream at
            # the generation index after the adopted first token
            rng = staged[4] if len(staged) > 4 else \
                (req.rng_seed, req.rng_gen + 1)
            first = self.engine.adopt_kv(slot, *staged[:4], rng=rng)
        except BlockAllocError:
            raise
        except Exception:                                # noqa: BLE001
            req._staged = None
            return self._prefill(slot, req)
        req._staged = None
        req.adopted = True
        self.counts["adopted"] += 1
        return first

    def _prefill(self, slot, req):
        """Local prefill with the request's sampler state at this
        placement: its next token is generation index base + tokens
        already delivered."""
        kwargs = {} if req.prefix_namespace is None else \
            {"namespace": req.prefix_namespace}
        return self.engine.prefill(
            slot, req.exec_prompt,
            rng=(req.rng_seed, req.rng_gen + len(req.tokens)), **kwargs)

    def _restore_staged_prefix(self, req):
        """Register a shipped prefix chain in the local prefix cache, once:
        the bundle is consumed whatever happens, and a restore that fails
        for any reason restores 0 tokens (the prefill that follows
        recomputes). The chain is cache-owned, so a preempted retry still
        matches it."""
        sp = req._staged_prefix
        if sp is None:
            return
        req._staged_prefix = None
        try:
            req.kv_restored_tokens = int(self.engine.restore_prefix(
                req.exec_prompt, sp[0], sp[1], sp[2], namespace=sp[3]))
        except Exception:                                # noqa: BLE001
            req.kv_restored_tokens = 0

    def _finish(self, req, status):
        req.status = status
        req.finished_at = self._clock()
        self.counts[status.lower()] += 1
        if status == DONE:
            self._completed.append(req)
        req._done.set()

    # -- metrics -------------------------------------------------------------------
    def metrics(self):
        """Counters and rates since construction. `decode_tokens_per_s`
        and `decode_step_ms` cover decode steps only (host clock around
        `engine.decode()`, which returns host tokens, so the device work
        is inside the window); with a speculative engine a step is one
        round (`decode_many`: gamma draft decodes and one verify) and
        `decode_step_ms` times rounds. `ttft_s_mean` is over completed
        requests. `requests["adopted"]` counts placements from staged KV
        bundles. `spec_*` appear once a speculative round has proposed
        tokens."""
        ttfts = [r.first_token_at - r.submitted_at for r in self._completed
                 if r.first_token_at is not None]
        out = {
            "steps": self._steps,
            "queue_depth": len(self._queue),
            "slot_occupancy": self.active_slots() / max(self.engine.slots, 1),
            "tokens_generated": self._tokens,
            "decode_tokens": self._decode_tokens,
            "decode_steps": self._decode_steps,
            "decode_tokens_per_s": (self._decode_tokens / self._decode_time_s
                                    if self._decode_time_s > 0 else 0.0),
            "decode_step_ms": (1e3 * self._decode_time_s / self._decode_steps
                               if self._decode_steps else None),
            "ttft_s_mean": sum(ttfts) / len(ttfts) if ttfts else None,
            "requests": dict(self.counts),
            "kernel_launches": getattr(self.engine, "kernel_launches", 0),
        }
        if self._spec_proposed:
            out["spec_proposed"] = self._spec_proposed
            out["spec_accepted"] = self._spec_accepted
            out["spec_acceptance_rate"] = (self._spec_accepted
                                           / self._spec_proposed)
        pool = getattr(self.engine, "block_pool", None)
        if pool is not None:
            out["blocks_in_use"] = pool.in_use
            out["blocks_total"] = pool.capacity
            pc = getattr(self.engine, "prefix_cache", None)
            out["prefix_cache_blocks"] = len(pc) if pc is not None else 0
            out["prefix_hits"] = pc.hits if pc is not None else 0
        return out
