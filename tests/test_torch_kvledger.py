"""The port's KV ledger (`paddle_tpu_torch.observability.kvledger` and its
hooks in the pool, the prefix cache, the tiers, the engine and the
scheduler) against the JAX package, on the CPU.

The JAX tiny GPT (hidden 128, 2 layers, 4 heads, vocab 1024) is built from
a fixed seed and its weights are carried into the port with
`load_jax_params`; the JAX engines run the gather path, the port its
default kernel path (the kernel's plain version on the CPU). Both
schedulers read one manual clock and each package's request ids start
from 0, so the ledgers' events (which carry no clock) compare event for
event. Then:

  * the shadow model's rules (impossible transitions, holder
    classification and drop preference, attribution nesting) and the
    prefix cache's COW accounting leave the port's shadow state and
    event stream equal to the JAX ledger's on the same calls;
  * a two-tenant burst through a small paged pool with the prefix cache
    (priority classes, sheds past the watermark, preemptions under
    allocation pressure, prefix hits) through both `Scheduler`s: the
    `kvledger.v1` stream parsed back from the port's serving JSONL equals
    the JAX run's, replays into the pool's exact free list and
    refcounts, leaves zero divergences, and `tools/serve_report.py`
    renders its residency table;
  * an injected `serving.kv_ledger_leak` is caught within one scheduler
    step as `serving_kv_ledger_divergence_total{invariant="free_list"}`,
    and `tools/metrics_report.py --compare` exits 1;
  * the ledger on and off: equal streams and capture counts for the
    dense, paged and speculative engines;
  * `_kv_block_bytes` is the JAX engine's for f32 and int8 pools; the
    fleet primes the `serving_kv_*` children at zero;
  * the tier events (`tier_demote` with `sat` from an int8 host tier,
    host-to-disk demotes, `tier_drop` with its reason, `tier_promote`)
    equal the JAX engine's over an evict-and-resubmit with a disk
    cascade, with zero divergences (tier residency included).

The tensor- and pipeline-parallel kinds of the reference's on/off test
are held in `tests/test_torch_pp.py`. Left out: the load harness
(`tools/load_harness.py` builds JAX engines; the burst here is scripted).

Metric values are read as deltas: registries are process-global.
"""
import itertools
import json
import os
import sys

import numpy as np
import pytest

import paddle_tpu
from paddle_tpu.observability import faults as jfaults
from paddle_tpu.observability import kvledger as jkvl
from paddle_tpu.serving import BlockPool as JBlockPool
from paddle_tpu.serving import PagedGenerationEngine as JPagedEngine
from paddle_tpu.serving import PrefixCache as JPrefixCache
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu.text.models import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.observability import faults as tfaults
from paddle_tpu_torch.observability import fleet as tfleet
from paddle_tpu_torch.observability import flight_recorder as tfr
from paddle_tpu_torch.observability import kvledger as tkvl
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.serving import (BlockPool, GenerationEngine,
                                      PagedGenerationEngine, PrefixCache,
                                      SpeculativeEngine, graphs)
from paddle_tpu_torch.serving import scheduler as tsched
from paddle_tpu_torch.text.models import gpt_tiny
from paddle_tpu_torch.text.models.convert import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import metrics_report  # noqa: E402
import serve_report  # noqa: E402

PKG = {"jax": dict(kvl=jkvl, pool=JBlockPool, cache=JPrefixCache,
                   sched=jsched, faults=jfaults),
       "port": dict(kvl=tkvl, pool=BlockPool, cache=PrefixCache,
                    sched=tsched, faults=tfaults)}


@pytest.fixture(scope="module")
def models():
    """(JAX tiny GPT, the port's tiny GPT on the CPU with its weights)."""
    paddle_tpu.seed(7)
    jm = jgpt_tiny()
    jm.eval()
    params = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, load_jax_params(gpt_tiny(device="cpu"), params)


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    """Faults disarmed and the ledger switch on around every test, and the
    port's postmortem bundles written under the test's own directory."""
    rec = tfr.get()
    prev_dir = rec.dir
    rec.dir = str(tmp_path / "pm")
    for pkg in PKG.values():
        pkg["faults"].disarm_all()
    yield
    rec.dir = prev_dir
    for pkg in PKG.values():
        pkg["faults"].disarm_all()
        pkg["kvl"].enable()


class Clock:
    """A clock that moves only when the script says so."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _RecordingExecutables(graphs.Executables):
    """The CUDA-graph bookkeeping on the CPU: the first run of a name
    counts as its capture; every run is eager."""

    def run(self, name, fn, inputs, safe=None, upload=True, device=None):
        if name not in self._graphs:
            self.capture_counts[name] = self.capture_counts.get(name, 0) + 1
            self._graphs[name] = True
        inputs.upload()
        return fn(), 0


def _prompt(seed, n):
    return [int(t) for t in np.random.RandomState(seed).randint(0, 1000, n)]


def _engine(pkg, models, **kw):
    jm, tm = models
    if pkg == "jax":
        return JPagedEngine(jm, attention_impl="gather", **kw)
    return PagedGenerationEngine(tm, device="cpu", **kw)


def _scheduler(pkg, eng, clock=None, **kw):
    mod = PKG[pkg]["sched"]
    if pkg == "port":
        kw["device"] = "cpu"
    if clock is not None:
        kw["clock"] = clock
    return mod.Scheduler(eng, **kw)


def _divergences():
    """The port's divergence counter, summed over its invariants."""
    flat = tmetrics.flatten_snapshot(tmetrics.registry().snapshot(),
                                     kinds=("counter",))
    return sum(v for k, v in flat.items()
               if k.startswith("serving_kv_ledger_divergence_total"))


def _shadow_state(shadow):
    return {"refs": list(shadow.refs), "allocated": set(shadow.allocated),
            "holders": {b: list(h) for b, h in shadow.holders.items()},
            "cached": dict(shadow.cached), "tiered": dict(shadow.tiered),
            "errors": list(shadow.errors), "applied": shadow.applied}


# ------------------------------------------------- the shadow model rules

def test_shadow_records_impossible_transitions():
    events = [{"seq": 0, "event": "alloc", "blocks": [1], "tenant": "a"},
              {"seq": 1, "event": "alloc", "blocks": [1], "tenant": "a"},
              {"seq": 2, "event": "ref", "blocks": [2], "tenant": "a"},
              {"seq": 3, "event": "unref", "blocks": [3], "tenant": "a"},
              {"seq": 4, "event": "free", "blocks": [1], "tenant": "a"},
              {"seq": 5, "event": "ref", "blocks": [9], "tenant": "a"},
              {"seq": 6, "event": "tier_drop", "blocks": [], "key": "x"}]
    states = {}
    for name, pkg in PKG.items():
        sh = pkg["kvl"].ShadowPool(4)
        for ev in events:
            sh.apply(ev)
        states[name] = _shadow_state(sh)
    assert states["port"] == states["jax"]
    errors = states["port"]["errors"]
    assert len(errors) == 6 and "double alloc" in errors[0]
    assert 1 not in states["port"]["allocated"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shadow_residency_counts_equal_jax_on_random_streams(seed):
    """The port's shadow keeps its (tenant, kind) counts as holders move;
    on random streams (impossible transitions included) its residency,
    free set and whole state equal the JAX shadow's recount after every
    event."""
    r = np.random.RandomState(seed)
    origins = ["prefill", "retire", "prefix_cache.match",
               "prefix_cache.insert", "prefix_cache.evict", None]
    kinds = ["alloc", "ref", "ref", "unref", "unref", "free",
             "cache_insert", "cache_evict", "share", "tier_demote",
             "tier_drop"]
    jsh, tsh = jkvl.ShadowPool(9), tkvl.ShadowPool(9)
    for seq in range(400):
        kind = kinds[r.randint(len(kinds))]
        ev = {"seq": seq, "event": kind,
              "blocks": [int(b) for b in r.randint(0, 10, r.randint(1, 3))],
              "tenant": [None, "a", "b"][r.randint(3)],
              "request_id": int(r.randint(3)),
              "origin": origins[r.randint(len(origins))]}
        if kind.startswith("tier_"):
            ev.update(blocks=[], key=f"k{r.randint(4)}", tier="host",
                      owner="a")
        jsh.apply(ev)
        tsh.apply(ev)
        assert tsh.tenant_kind_blocks() == jsh.tenant_kind_blocks(), seq
        assert tsh.free_set() == jsh.free_set(), seq
    assert _shadow_state(tsh) == _shadow_state(jsh)
    assert tsh.errors


def _holder_script(kvl):
    """One block with three holders of three kinds, then the drops; the
    (tenant, kind) residency after each stage."""
    led = kvl.KVLedger(8)
    seen = []
    with kvl.attribution(request_id=1, tenant="a", origin="prefill"):
        led.pool_alloc([3])
        with kvl.origin_scope("prefix_cache.insert"):
            led.pool_ref(3)
        led.cache_insert((3,))
    with kvl.attribution(request_id=2, tenant="b", origin="prefill"):
        with kvl.origin_scope("prefix_cache.match"):
            led.pool_ref(3)
        led.cache_share((3,), tokens=4)
    seen.append(led.shadow.tenant_kind_blocks())
    with kvl.attribution(request_id=2, tenant="b", origin="retire"):
        led.pool_unref(3)
    seen.append(led.shadow.tenant_kind_blocks())
    with kvl.attribution(request_id=None, tenant=None,
                         origin="prefix_cache.evict"):
        led.cache_evict((3,))
        led.pool_unref(3)
    seen.append(led.shadow.tenant_kind_blocks())
    with kvl.attribution(request_id=1, tenant="a", origin="retire"):
        led.pool_unref(3)
        led.pool_free(3)
    seen.append(led.shadow.tenant_resident_totals())
    return led, seen


def test_holder_classification_and_drop_preference():
    """An evict-origin unref drops the cache's own holder, a request-id
    match that request's, tenant fallbacks after: the port's stages,
    events and final shadow equal the JAX ledger's."""
    (jled, jseen), (tled, tseen) = (_holder_script(jkvl),
                                    _holder_script(tkvl))
    assert tseen == jseen
    assert tseen[0] == {("a", "private"): 1, ("a", "cached"): 1,
                        ("b", "shared"): 1}
    assert tseen[1] == {("a", "private"): 1, ("a", "cached"): 1}
    assert tseen[2] == {("a", "private"): 1} and tseen[3] == {}
    assert tled.events == jled.events
    assert _shadow_state(tled.shadow) == _shadow_state(jled.shadow)
    assert tled.shadow.free_set() == set(range(1, 8))


def test_attribution_context_nests_and_restores():
    assert tkvl.current_attribution() is None
    with tkvl.attribution(request_id=7, tenant="t", origin="prefill"):
        with tkvl.origin_scope("prefix_cache.match"):
            assert tkvl.current_attribution() == {
                "request_id": 7, "tenant": "t",
                "origin": "prefix_cache.match"}
        assert tkvl.current_attribution()["origin"] == "prefill"
    assert tkvl.current_attribution() is None
    # the two packages' contexts are their own
    with tkvl.attribution(request_id=1, tenant="x", origin="prefill"):
        assert jkvl.current_attribution() is None


def _cow_script(pkg):
    """The COW chain's life through a pool and a cache with a ledger:
    insert, cross-request share, staggered retires, leaf-first eviction.
    Returns (ledger, [(reconciler divergences, evictable())])."""
    kvl = PKG[pkg]["kvl"]
    pool = PKG[pkg]["pool"](num_blocks=8, block_size=4)
    ledger = kvl.KVLedger(8, block_bytes=64)
    pool.attach_ledger(ledger)
    cache = PKG[pkg]["cache"](pool, 4)
    cache.attach_ledger(ledger)
    recon = kvl.LedgerReconciler(ledger, pool, cache)
    prompt = list(range(12))
    stages = []

    def mark():
        stages.append((recon.check(), cache.evictable(), len(cache),
                       ledger.shadow.tenant_kind_blocks()))
    with kvl.attribution(request_id=1, tenant="a", origin="prefill"):
        row = pool.alloc(3)
        cache.insert(prompt, row, 8)
    mark()
    with kvl.attribution(request_id=2, tenant="b", origin="prefill"):
        ids, n = cache.match(prompt)
    assert list(ids) == list(row[:2]) and n == 8
    mark()
    assert cache.evict(8) == 0
    mark()
    with kvl.attribution(request_id=1, tenant="a", origin="retire"):
        for b in row:
            pool.unref(b)
    with kvl.attribution(request_id=2, tenant="b", origin="retire"):
        for b in ids:
            pool.unref(b)
    mark()
    assert cache.evict(8) == 2
    mark()
    assert pool.available == pool.capacity
    assert ledger.shadow.free_set() == set(pool._free)
    return ledger, stages


def test_prefix_cache_evictable_and_eviction_accounting_under_cow():
    jled, jstages = _cow_script("jax")
    tled, tstages = _cow_script("port")
    assert tstages == jstages
    assert tled.events == jled.events
    assert all(divs == [] for divs, *_ in tstages)
    assert [ev for _, ev, _, _ in tstages] == [0, 0, 0, 2, 0]
    assert tstages[1][3] == {("a", "private"): 3, ("a", "cached"): 2,
                             ("b", "shared"): 2}
    assert tstages[3][3] == {("a", "cached"): 2}
    assert not tled.shadow.errors


# ------------------------------------- the two-tenant burst, event for event

BURST_ENGINE = dict(slots=3, max_len=32, block_size=4, num_blocks=10,
                    enable_prefix_cache=True)


def _burst(pkg, models, tmp_path, monkeypatch):
    """Two tenants through a 9-block pool: each shares an 8-token prefix
    across its prompts (prefix hits), the spike tenant bursts batch
    requests past the shed watermark (sheds), and three slots of up to
    four blocks each outgrow the pool (preemptions)."""
    mod = PKG[pkg]["sched"]
    monkeypatch.setattr(mod.Request, "_ids", itertools.count())
    clock = Clock()
    eng = _engine(pkg, models, **BURST_ENGINE)
    path = str(tmp_path / f"{pkg}_burst.jsonl")
    sched = _scheduler(pkg, eng, clock, max_queue=64, shed_watermark=3,
                       metrics_path=path)
    shared = {"steady": _prompt(500, 8), "spike": _prompt(501, 8)}
    handles, shed = [], []

    def submit(i, tenant, priority):
        prompt = shared[tenant] + _prompt(600 + i, 3 + i % 4)
        try:
            handles.append(sched.submit(prompt, max_new_tokens=4,
                                        tenant=tenant, priority=priority))
        except mod.LoadShedError:
            shed.append(i)

    for i in range(4):                       # the steady tenant warms up
        submit(i, "steady", "standard")
    for _ in range(3):
        clock.t += 1.0
        sched.step()
    for i in range(4, 14):                   # the spike: a batch burst
        submit(i, "spike", ("batch", "standard")[i % 3 == 0])
    for i in range(14, 18):
        submit(i, "steady", "interactive")
    while sched.step():
        clock.t += 1.0
    for i in range(18, 22):                  # the tail: warm prefixes
        submit(i, ("steady", "spike")[i % 2], "standard")
    while sched.step():
        clock.t += 1.0
    sched.close()
    return eng, sched, handles, shed, path


def test_two_tenant_burst_ledger_equals_jax_and_replays(models, tmp_path,
                                                        monkeypatch):
    div0 = _divergences()
    runs = {pkg: _burst(pkg, models, tmp_path, monkeypatch)
            for pkg in ("jax", "port")}
    jeng, jsch, jh, jshed, jpath = runs["jax"]
    teng, tsch, th, tshed, tpath = runs["port"]
    assert tshed == jshed and tshed, "the burst shed nothing"
    assert [(h.status, h.tokens) for h in th] == \
        [(h.status, h.tokens) for h in jh]
    assert all(h.status == "DONE" for h in th)
    assert tsch.counts == jsch.counts
    assert tsch.counts["serving.preempted"] > 0
    recs = {}
    for pkg, path in (("jax", jpath), ("port", tpath)):
        with open(path) as f:
            recs[pkg] = [json.loads(line) for line in f if line.strip()]
    kv = {pkg: [r for r in rs if r["kind"] == "kvledger"]
          for pkg, rs in recs.items()}
    # the port's stream, parsed back from its JSONL, is the JAX stream
    assert kv["port"] == kv["jax"]
    assert len(kv["port"]) == len(teng.kv_ledger.events)
    kinds = {r["event"] for r in kv["port"]}
    assert {"alloc", "ref", "unref", "free", "share",
            "cache_insert"} <= kinds
    assert {r["origin"] for r in kv["port"]} >= {
        "prefill", "retire", "preempt", "decode_grow",
        "prefix_cache.match", "prefix_cache.insert"}
    assert {r["tenant"] for r in kv["port"]} >= {"steady", "spike"}
    # THE replay: the round-tripped stream rebuilds the pool exactly
    pool = teng.block_pool
    shadow = tkvl.replay_events(kv["port"], pool.num_blocks)
    assert not shadow.errors
    assert shadow.refs == [int(r) for r in pool._refs]
    assert shadow.free_set() == set(int(b) for b in pool._free)
    assert set(shadow.allocated) == set(shadow.cached)   # no leak
    assert tsch._kv_reconciler.divergences == []
    assert _divergences() == div0
    # the residency gauges follow the shadow
    flat = tmetrics.flatten_snapshot(tmetrics.registry().snapshot())
    for (tenant, kind), n in shadow.tenant_kind_blocks().items():
        assert flat[f"serving_kv_blocks{{kind={kind},tenant={tenant}}}"] \
            == n
        assert flat[f"serving_kv_bytes{{kind={kind},tenant={tenant}}}"] \
            == n * teng._kv_block_bytes()
    # serve_report validates the JSONL and renders the residency table
    assert serve_report.validate_records(recs["port"]) == []
    digest = serve_report.summarize(recs["port"])
    assert digest["kvledger_events"] == len(kv["port"])
    assert set(digest["kv_residency"]["tenants"]) <= {"steady", "spike",
                                                     "default"}
    text = serve_report.render(digest)
    assert "KV residency" in text and "prefix-chain sharing" in text


# ------------------------------------------------ the leak and its gate

def test_injected_leak_caught_within_one_step_and_gates_compare(
        models, tmp_path, capsys):
    rec = tfr.enable()
    try:
        eng = _engine("port", models, slots=2, max_len=32, block_size=4,
                      num_blocks=12, enable_prefix_cache=False)
        sched = _scheduler("port", eng, max_queue=8)
        assert sched._kv_reconciler is not None
        baseline = str(tmp_path / "base.jsonl")
        after = str(tmp_path / "after.jsonl")
        tmetrics.registry().write_snapshot(baseline)
        spec = tfaults.arm("serving.kv_ledger_leak", "truncate", nth=1,
                           max_fires=1)
        hs = [sched.submit(_prompt(5 + i, 5), max_new_tokens=4)
              for i in range(2)]
        while True:
            more = sched.step()
            if spec.fires:
                # caught at the boundary of the step the leak happened in
                assert sched._kv_reconciler.divergences, \
                    "leak not latched within one scheduler step"
                break
            assert more, "the leak site never fired (no block freed)"
        msgs = sched._kv_reconciler.divergences
        assert any("free_list" in m and "leaked" in m for m in msgs), msgs
        sched.run_until_idle()
        assert all(h.status == "DONE" for h in hs)
        pm = sched._kv_reconciler.last_postmortem
        assert pm and os.path.exists(pm)
        tmetrics.registry().write_snapshot(after)
    finally:
        tfaults.disarm_all()
        rec.disable()
    rc = metrics_report.main(["--compare", baseline, after])
    out = capsys.readouterr().out
    assert rc == 1
    assert "serving_kv_ledger_divergence_total" in out
    assert 'invariant="free_list"' in out or "invariant=free_list" in out


# ------------------------- the ledger only observes: on and off, per kind

def _kind_engine(kind, models):
    _, tm = models
    kw = dict(slots=2, max_len=32, device="cpu")
    if kind == "dense":
        return GenerationEngine(tm, **kw)
    paged = dict(kw, block_size=4, num_blocks=12, enable_prefix_cache=False)
    if kind == "spec":
        return SpeculativeEngine(tm, gamma=2, draft_layers=1, **paged)
    return PagedGenerationEngine(tm, **paged)


@pytest.mark.parametrize("kind", ["dense", "paged", "spec"])
def test_ledger_on_and_off_streams_and_captures_equal(models, kind):
    prompts = [_prompt(11 + i, 5) for i in range(2)]
    streams, captures, ledgers = [], [], []
    for on in (True, False):
        (tkvl.enable if on else tkvl.disable)()
        try:
            eng = _kind_engine(kind, models)
        finally:
            tkvl.enable()
        if kind != "dense":
            eng._exe = _RecordingExecutables(eng.device)
        sched = _scheduler("port", eng, max_queue=8)
        hs = [sched.submit(p, max_new_tokens=4) for p in prompts]
        sched.run_until_idle()
        assert all(h.status == "DONE" for h in hs)
        streams.append([h.tokens for h in hs])
        captures.append(eng.capture_counts)
        ledgers.append(getattr(eng, "kv_ledger", None))
    assert streams[0] == streams[1]
    assert captures[0] == captures[1]
    if kind != "dense":
        assert captures[0]["decode" if kind == "paged"
                           else "spec_verify"] == 1
    assert ledgers[1] is None
    if kind == "dense":
        assert ledgers[0] is None
    else:
        assert ledgers[0] is not None and len(ledgers[0].events) > 0


def test_block_bytes_priced_from_pool_dtype(models):
    cfg = models[1].cfg
    h, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    kw = dict(slots=2, max_len=32, block_size=4, num_blocks=6,
              enable_prefix_cache=False)
    for kv_dtype, per_side in (("float32", 4 * h * d * 4),
                               ("int8", 4 * h * d + 4 * h)):
        port = _engine("port", models, kv_dtype=kv_dtype, **kw)
        jax_ = _engine("jax", models, kv_dtype=kv_dtype, **kw)
        assert port._kv_block_bytes() == jax_._kv_block_bytes() \
            == 2 * per_side * cfg.num_layers
        assert port.kv_ledger.block_bytes == port._kv_block_bytes()


def test_fleet_priming_creates_kv_children_at_zero():
    tfleet.prime_tenant_series(["primed_t"])
    flat = tmetrics.flatten_snapshot(tmetrics.registry().snapshot())
    for kind in ("private", "shared", "cached", "host", "disk"):
        assert flat[
            f"serving_kv_blocks{{kind={kind},tenant=primed_t}}"] == 0
        assert flat[
            f"serving_kv_bytes{{kind={kind},tenant=primed_t}}"] == 0


def test_metrics_report_failure_class_matches_divergence_and_leak():
    assert metrics_report._FAIL_PAT.search(
        "serving_kv_ledger_divergence_total")
    assert metrics_report._FAIL_PAT.search("serving_kv_ledger_leak")


# ------------------------------------------------------------ tier events

def _tier_run(pkg, models, tmp_path, monkeypatch):
    """A prompt served, its chain evicted into an int8 host tier of two
    blocks cascading to a disk tier of one (host demotes with `sat`, disk
    demotes, capacity drops), then served again (a promotion), then the
    rest discarded with a reason."""
    mod = PKG[pkg]["sched"]
    monkeypatch.setattr(mod.Request, "_ids", itertools.count())
    eng = _engine(pkg, models, slots=2, max_len=64, block_size=8,
                  enable_kv_tiers=True, host_tier_blocks=2,
                  host_tier_dtype="int8",
                  disk_tier_dir=str(tmp_path / f"{pkg}_disk"),
                  disk_tier_blocks=1)
    sched = _scheduler(pkg, eng, Clock(), max_queue=8)
    prompts = [_prompt(700, 41), _prompt(701, 26)]
    streams = []
    for p in prompts:
        h = sched.submit(p, max_new_tokens=4, tenant="acme")
        sched.run_until_idle()
        streams.append(h.tokens)
    assert eng.prefix_cache.evict(999) > 0
    sched.step()
    h = sched.submit(prompts[1], max_new_tokens=4, tenant="acme")
    sched.run_until_idle()
    streams.append(h.tokens)
    for key in list(eng.kv_tiers.residency()):
        eng.kv_tiers.discard(key, reason="namespace flush")
    sched.step()
    return eng, sched, streams


def test_tier_events_equal_jax_with_reasons_and_sat(models, tmp_path,
                                                    monkeypatch):
    jeng, jsch, jstreams = _tier_run("jax", models, tmp_path, monkeypatch)
    teng, tsch, tstreams = _tier_run("port", models, tmp_path, monkeypatch)
    assert tstreams == jstreams
    tev, jev = teng.kv_ledger.events, jeng.kv_ledger.events
    assert [e["event"] for e in tev] == [e["event"] for e in jev]
    assert tev == jev
    tier = [e for e in tev if e["event"].startswith("tier_")]
    host = [e for e in tier if e["event"] == "tier_demote"
            and e["tier"] == "host"]
    assert host and all(0.0 < e["sat"] <= 1.0 for e in host)
    assert any(e["event"] == "tier_demote" and e["tier"] == "disk"
               and "sat" not in e for e in tier)
    reasons = {e.get("reason") for e in tier if e["event"] == "tier_drop"}
    assert {"capacity", "namespace flush"} <= reasons
    assert any(e["event"] == "tier_promote" for e in tier)
    assert all(e["owner"] == "default" for e in tier)
    assert tsch._kv_reconciler.divergences == []
    assert jsch._kv_reconciler.divergences == []
    assert teng.kv_ledger.shadow.tiered == {}
