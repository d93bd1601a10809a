"""Deterministic fault injection: the chaos half of the robustness layer.

Counterpart of `paddle_tpu/observability/faults.py`, copied. Named SITES
on the failure-prone paths can be armed to raise, delay, drop a
connection or truncate, with probability, every-Nth-call and max-fire
triggers, so the containment machinery is proven by tests that replay
the exact same fault schedule every run.

The `SITES` catalogue and the `PTN_FAULTS` variable are the JAX
package's, so one variable arms a mixed fleet. The port fires these
sites so far, each before any engine state moves:

  serving.decode_step  PagedGenerationEngine.decode and
                       SpeculativeEngine.decode_many, first thing: a
                       raise exercises the scheduler's quarantine/reprobe
                       path
  serving.block_alloc  BlockPool.alloc, before the free-list pop: with
                       exc=BlockAllocError it simulates pool exhaustion
                       (preemption); the default raise exercises the
                       contained prefill failure
  serving.weight_swap  swap_params, before the first copy: a raise
                       refuses the swap and the old weights keep serving
  serving.kv_quant     PagedGenerationEngine.decode on int8 KV pools:
                       truncate multiplies one in-use block's K and V
                       scale rows of layer 0 by 64, in place
  serving.kv_handoff   pack_kv_bundle and unpack_kv_bundle: a raise at
                       either end makes the caller fall back to a local
                       prefill
  serving.kv_restore   restore_prefix: a raise or truncate restores
                       nothing and ticks serving_kv_tier_corrupt_total
  serving.kv_ledger_leak  BlockPool.unref, when a last reference drops:
                       truncate skips the free-list return while the KV
                       ledger records the free, so the reconciler's
                       free_list invariant diverges within one step
  numerics.corrupt     the engines' decode (and speculative round) before
                       the step runs: nan / inf set one element of the
                       decode weight named by `target=` (the scale of an
                       int8 entry), scale_zero zeroes an int8 entry's
                       scale, in the decode storage the captured graph
                       reads; fire() returns the spec and the engine does
                       the damage
  serving.pp_handoff   the pipeline-parallel engines' stage boundary
                       (`serving/distributed/pp.py`): on every hop, before
                       the activation is copied into the next stage's
                       input buffer; a raise fails the step mid-ring
                       (the scheduler's quarantine contains it)

The other seven are fired by the modules that own them:
`ps.rpc.connect`, `ps.rpc.send` and `serving.rpc.serve`
(`distributed/ps/rpc.py`), `checkpoint.write`
(`framework/ckpt_commit.py`), `serving.adapter_swap` (the engine's and
the scheduler's adapter swaps), `serving.kv_spill`
(`serving/kv_tiers/store.py`) and `dataloader.next` (`io/__init__.py`):
all 16 sites of `SITES` are fired.

Arming, in-process:

    from paddle_tpu_torch.observability import faults
    faults.arm("serving.decode_step", mode="raise", max_fires=1)

or across processes via the environment (parsed at import):

    PTN_FAULTS="serving.decode_step=raise:nth=3:max=1;serving.kv_quant=delay"

Zero-cost when disarmed: `fire(site)` is one function call and one empty-
dict check. Every fired fault increments
`faults_injected_total{site,mode}` and emits a `fault::<site>` span into
the port's host tracer (`paddle_tpu_torch.profiler`, found through
sys.modules, never imported).
"""
import os
import random
import sys
import threading
import time

from . import metrics as _metrics

__all__ = ["FaultSpec", "FaultInjected", "SITES", "ENV_VAR", "arm",
           "disarm", "disarm_all", "armed", "fire", "load_env"]

# the documented catalogue; arm() accepts any name so tests can add sites
SITES = ("ps.rpc.connect", "ps.rpc.send", "checkpoint.write",
         "serving.decode_step", "serving.block_alloc",
         "serving.kv_handoff", "serving.kv_quant", "serving.weight_swap",
         "serving.adapter_swap", "serving.pp_handoff",
         "serving.kv_ledger_leak", "serving.kv_spill",
         "serving.kv_restore", "serving.rpc.serve", "numerics.corrupt",
         "dataloader.next")

ENV_VAR = "PTN_FAULTS"
# nan/inf/scale_zero are caller-interpreted like truncate: fire()
# returns the spec and the call site (the engine) performs the damage.
# slow = delay with deterministic jitter (a gray worker is never
# *uniformly* slow); flaky is caller-interpreted — the serve site turns
# it into an in-band error frame, not a torn connection.
MODES = ("raise", "delay", "slow", "drop", "truncate", "nan", "inf",
         "scale_zero", "flaky")
CALLER_MODES = ("truncate", "nan", "inf", "scale_zero", "flaky")

_M_INJECTED = _metrics.counter(
    "faults_injected_total", "Injected faults fired, by site and mode",
    labelnames=("site", "mode"))


class FaultInjected(RuntimeError):
    """Default exception for `raise` mode (sites that retry on specific
    exception types arm a matching `exc` instead)."""


class FaultSpec:
    """One armed site: trigger rule + fault mode + deterministic RNG.

    Trigger: fires when `nth` divides the site's call count, OR (if
    nth == 0) when the seeded RNG draws below `p`. `max_fires` bounds the
    total; afterwards the site goes quiet (but stays armed, keeping the
    call counter deterministic)."""

    __slots__ = ("site", "mode", "p", "nth", "delay_s", "max_fires", "seed",
                 "exc", "target", "calls", "fires", "_rng", "_lock")

    def __init__(self, site, mode, p=1.0, nth=0, delay_s=0.05,
                 max_fires=None, seed=0, exc=None, target=None):
        if mode not in MODES:
            raise ValueError(f"unknown fault mode {mode!r}; want {MODES}")
        self.site = site
        self.mode = mode
        self.p = float(p)
        self.nth = int(nth)
        self.delay_s = float(delay_s)
        self.max_fires = None if max_fires is None else int(max_fires)
        self.seed = int(seed)
        self.exc = exc
        # the tensor a numerics.corrupt spec poisons (caller-interpreted)
        self.target = None if target is None else str(target)
        self.calls = 0
        self.fires = 0
        # decorrelate sites under one seed, keep each site reproducible
        self._rng = random.Random(f"{self.seed}:{site}")
        self._lock = threading.Lock()

    def _should_fire(self):
        with self._lock:
            self.calls += 1
            if self.max_fires is not None and self.fires >= self.max_fires:
                return False
            if self.nth > 0:
                hit = self.calls % self.nth == 0
            else:
                hit = self._rng.random() < self.p
            if hit:
                self.fires += 1
            return hit

    def _jitter_s(self):
        """Jittered sleep for `slow` mode: uniform in
        [0.5*delay_s, 1.5*delay_s), drawn from the spec's seeded RNG so
        a replayed fault schedule sleeps the same wall-clock."""
        with self._lock:
            return self.delay_s * (0.5 + self._rng.random())

    def _exception(self):
        if self.exc is not None:
            return self.exc(f"[fault-injection] {self.site}") \
                if isinstance(self.exc, type) else self.exc
        if self.mode == "drop":
            return ConnectionResetError(
                f"[fault-injection] dropped connection at {self.site}")
        return FaultInjected(f"[fault-injection] raised at {self.site}")

    def __repr__(self):
        return (f"FaultSpec({self.site!r}, {self.mode!r}, p={self.p}, "
                f"nth={self.nth}, fires={self.fires}/{self.max_fires})")


_specs = {}                      # site -> [FaultSpec]; empty == disarmed
_specs_lock = threading.Lock()


def arm(site, mode="raise", **kwargs):
    """Arm `site` with one more spec (specs STACK — e.g. a drop and a
    delay can both ride `ps.rpc.send`; they trigger independently).
    Returns the FaultSpec."""
    spec = FaultSpec(site, mode, **kwargs)
    with _specs_lock:
        _specs.setdefault(site, []).append(spec)
    return spec


def disarm(site):
    """Remove every spec armed on `site`."""
    with _specs_lock:
        _specs.pop(site, None)


def disarm_all():
    with _specs_lock:
        _specs.clear()


def armed(site=None):
    """The list of specs armed on `site`, or a {site: [specs]} copy when
    site is None."""
    with _specs_lock:
        if site is not None:
            return list(_specs.get(site, ()))
        return {k: list(v) for k, v in _specs.items()}


def _emit_span(site, spec):
    """`fault::<site>` into the host tracer / flight-recorder ring, if the
    profiler package is loaded (sys.modules only — never an import)."""
    mod = sys.modules.get("paddle_tpu_torch.profiler")
    tracer = getattr(mod, "_tracer", None)
    if tracer is None:
        return
    try:
        span = tracer.begin(f"fault::{site}", mod.TracerEventType.UserDefined,
                            attrs={"mode": spec.mode, "fire": spec.fires,
                                   "call": spec.calls})
        tracer.end(span)
    except Exception:                                        # noqa: BLE001
        pass                      # observability must never add a failure


def fire(site, key=None):
    """The injection point. Returns None when the site is quiet; when an
    armed spec fires:

      raise/drop -> raises (spec.exc, or ConnectionResetError for drop)
      delay      -> sleeps spec.delay_s, then keeps evaluating (a delay
                    can precede a drop or a truncate)
      slow       -> sleeps a jittered delay_s (0.5x-1.5x), then keeps
                    evaluating — the gray-worker latency mode
      truncate   -> returns the spec; the CALL SITE performs the tear
                    (only file writers interpret this mode)
      nan/inf/scale_zero -> returns the spec; the CALL SITE poisons the
                    tensor named by spec.target (only the numerics
                    chaos hook interprets these modes)
      flaky      -> returns the spec; the CALL SITE answers with an
                    in-band error (only serving.rpc.serve interprets it)

    `key` scopes the call: a spec armed with `target=` only fires when
    the caller's key matches (the serve site passes its own endpoint, so
    one worker in a shared process can be made gray while its peers stay
    healthy). Specs without a target fire for every key; callers that
    pass no key see every spec (numerics.corrupt keeps interpreting
    `target` as a tensor name itself).

    Stacked specs on one site trigger independently, evaluated in arm
    order. When BOTH a caller-interpreted spec and a delay fire on one
    call, the caller-interpreted spec is returned regardless of arm
    order — the caller must see the tear, not the sleep.
    """
    if not _specs:
        return None
    specs = _specs.get(site)
    if not specs:
        return None
    fired = None
    for spec in specs:
        if (key is not None and spec.target is not None
                and spec.target != str(key)):
            continue              # scoped to a different endpoint
        if not spec._should_fire():
            continue
        _M_INJECTED.labels(site=site, mode=spec.mode).inc()
        _emit_span(site, spec)
        if spec.mode == "delay":
            time.sleep(spec.delay_s)
            if fired is None:
                fired = spec
        elif spec.mode == "slow":
            time.sleep(spec._jitter_s())
            if fired is None:
                fired = spec
        elif spec.mode in CALLER_MODES:
            fired = spec          # outranks delay for the caller
        else:
            raise spec._exception()
    return fired


def load_env(value=None):
    """Parse `PTN_FAULTS` (or an explicit string) and arm the sites it
    names. Format, `;`-separated:

        site=mode[:p=0.05][:nth=3][:delay=0.2][:max=1][:seed=7][:target=name]

    Returns the list of armed FaultSpecs (empty when unset)."""
    raw = os.environ.get(ENV_VAR, "") if value is None else value
    out = []
    for part in raw.split(";"):
        part = part.strip()
        if not part:
            continue
        head, *opts = part.split(":")
        site, _, mode = head.partition("=")
        if not site or not mode:
            raise ValueError(f"bad {ENV_VAR} entry {part!r}: want "
                             f"site=mode[:key=val...]")
        kwargs = {}
        keymap = {"p": ("p", float), "nth": ("nth", int),
                  "delay": ("delay_s", float), "max": ("max_fires", int),
                  "seed": ("seed", int), "target": ("target", str)}
        for opt in opts:
            k, _, v = opt.partition("=")
            if k not in keymap:
                raise ValueError(f"bad {ENV_VAR} option {opt!r} in {part!r}")
            name, conv = keymap[k]
            kwargs[name] = conv(v)
        out.append(arm(site, mode=mode, **kwargs))
    return out


# forked workers inherit the env: arming happens at import, before any
# framework subsystem can hit a site
if os.environ.get(ENV_VAR):
    load_env()
