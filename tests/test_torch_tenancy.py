"""The port's multi-tenant serving (`paddle_tpu_torch.serving.tenancy`, the
engines' adapters, the scheduler's token buckets, quotas and adapter
swaps) against the JAX package, on the CPU.

The JAX tiny GPT (hidden 128, 2 layers, 4 heads, vocab 1024) is built from
a fixed seed and its weights are carried into the port with
`load_jax_params`; adapter states are the same numpy dicts in both
packages (`init_adapter_state` draws them from a seed in the same order).
The JAX engines run the gather path, the port its default kernel path
(the kernel's plain version on the CPU). Then:

  * `lora_delta` equals the JAX delta; the bank pads lower ranks, folds
    alpha/r into B and validates everything before it writes a row, its
    device rows equal to the JAX bank's;
  * a batch mixing a tenant and the base model streams what the JAX dense
    and paged engines stream with the same bank, token for token; the
    base row is the bank-less engine's, and a bank no slot is bound to
    changes nothing; int8 decode weights compose with the delta in float;
    the speculative engine's adapted stream is the one-token loop's;
  * the capture counts of a recording stand-in for the CUDA graphs equal
    the JAX engines' trace counts over the same call sequence;
  * the registry: what either package publishes the other resolves; a
    torn newest commit falls back, an all-torn tenant gets base weights;
  * the scheduler: an adapter swap between steps and its chaos match the
    JAX scheduler's streams and outcomes; namespaces isolate and quotas
    order eviction as the JAX cache does; the token bucket and the rate
    limiter, ahead of shedding, give the JAX decisions and request
    records field for field.
"""
import itertools
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.observability import faults as jfaults
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.serving import GenerationEngine as JDenseEngine
from paddle_tpu.serving import PagedGenerationEngine as JPagedEngine
from paddle_tpu.serving import SpeculativeEngine as JSpeculativeEngine
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu.serving.blocks import BlockPool as JBlockPool
from paddle_tpu.serving.prefix_cache import PrefixCache as JPrefixCache
from paddle_tpu.serving import tenancy as jten
from paddle_tpu.text.models import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.observability import faults as tfaults
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.serving import (GenerationEngine,
                                      PagedGenerationEngine,
                                      SpeculativeEngine, graphs)
from paddle_tpu_torch.serving import scheduler as tsched
from paddle_tpu_torch.serving import tenancy as tten
from paddle_tpu_torch.serving.blocks import BlockPool
from paddle_tpu_torch.serving.prefix_cache import PrefixCache
from paddle_tpu_torch.text.models import gpt_tiny
from paddle_tpu_torch.text.models.convert import load_jax_params

SLOTS = dict(slots=2, max_len=64)
PAGED = dict(SLOTS, block_size=8)
PKG = {"jax": dict(ten=jten, sched=jsched, faults=jfaults,
                   metrics=jmetrics),
       "port": dict(ten=tten, sched=tsched, faults=tfaults,
                    metrics=tmetrics)}


@pytest.fixture(scope="module")
def models():
    """(JAX tiny GPT, the port's tiny GPT on the CPU with its weights)."""
    paddle_tpu.seed(7)
    jm = jgpt_tiny()
    jm.eval()
    params = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, load_jax_params(gpt_tiny(device="cpu"), params)


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.disarm_all()
    tfaults.disarm_all()
    yield
    jfaults.disarm_all()
    tfaults.disarm_all()


def _prompt(seed, n):
    return [int(t) for t in np.random.RandomState(seed).randint(0, 1000, n)]


def _engine(pkg, models, kind="paged", **kw):
    jm, tm = models
    if kind == "dense":
        return JDenseEngine(jm, **SLOTS, **kw) if pkg == "jax" else \
            GenerationEngine(tm, device="cpu", **SLOTS, **kw)
    if pkg == "jax":
        cls = JSpeculativeEngine if kind == "spec" else JPagedEngine
        return cls(jm, attention_impl="gather", **PAGED, **kw)
    cls = SpeculativeEngine if kind == "spec" else PagedGenerationEngine
    return cls(tm, device="cpu", **PAGED, **kw)


def _bank(pkg, cfg, rank=4, seed=1, n=3):
    """A bank with tenant 'acme' loaded at scale 1.0 (its delta flips the
    tiny model's argmaxes)."""
    ten = PKG[pkg]["ten"]
    bank = ten.AdapterBank(cfg, n_adapters=n, rank=rank)
    bank.load("acme", jten.init_adapter_state(cfg, rank, seed=seed,
                                              scale=1.0))
    return bank


def _counter(pkg, name):
    mod = PKG[pkg]["metrics"]
    flat = mod.flatten_snapshot(mod.registry().snapshot(),
                                kinds=("counter",))
    return flat.get(name, 0.0)


def _decode_rows(eng, firsts, steps):
    rows = [[int(f)] for f in firsts]
    for _ in range(steps):
        if hasattr(eng, "ensure_decode_capacity"):
            eng.ensure_decode_capacity()
        out = eng.decode()
        for s in range(len(rows)):
            rows[s].append(int(out[s]))
    return rows


def _mixed_rows(pkg, models, kind="paged", steps=7, bank=True, bind=True,
                **kw):
    """Two prompts; slot 1 bound to 'acme' (when `bind`)."""
    jm, _ = models
    eng = _engine(pkg, models, kind, **kw)
    if bank:
        eng.attach_adapters(_bank(pkg, jm.cfg))
    firsts = [eng.prefill(s, _prompt(3 + s, 6 + 5 * s)) for s in range(2)]
    if bind:
        eng.set_slot_adapter(1, eng.adapter_bank.slot_of("acme"))
    return _decode_rows(eng, firsts, steps), eng


# ------------------------------------------------------------ adapter math
def test_lora_delta_matches_jax():
    """Row s takes adapter ids[s]'s delta, as the JAX einsum computes it;
    a base row (id 0, a zero row) adds exactly zero."""
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 8, 4)).astype(np.float32)
    b = rng.normal(size=(3, 4, 5)).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0
    x = rng.normal(size=(3, 2, 8)).astype(np.float32)
    ids = np.asarray([0, 2, 1], np.int32)
    want = np.asarray(jten.lora_delta(jnp.asarray(x), jnp.asarray(a),
                                      jnp.asarray(b), jnp.asarray(ids)))
    got = tten.lora_delta(torch.from_numpy(x), torch.from_numpy(a),
                          torch.from_numpy(b),
                          torch.from_numpy(ids)).numpy()
    assert np.all(got[0] == 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_bank_pads_folds_and_validates_before_writing(models):
    """A rank-2 adapter in a rank-8 bank is zero-padded with alpha/r
    folded into B (rows equal to the JAX bank's, bit for bit, and a delta
    of x @ A @ B * alpha/r); a bad state raises before any row moves; a
    drop zeroes the row for reuse."""
    jm, _ = models
    cfg = jm.cfg
    st = jten.init_adapter_state(cfg, 2, seed=3, scale=0.5, alpha=4.0)
    banks = {pkg: PKG[pkg]["ten"].AdapterBank(cfg, n_adapters=3, rank=8)
             for pkg in PKG}
    assert [b.load("t", st) for b in banks.values()] == [1, 1]
    tree = banks["port"].device_tree("cpu")
    jtree = banks["jax"].device_tree()
    for i, layer in enumerate(tree["layers"]):
        for t, (a, b) in layer.items():
            np.testing.assert_array_equal(
                a.numpy(), np.asarray(jtree["layers"][i][t][0]))
            np.testing.assert_array_equal(
                b.numpy(), np.asarray(jtree["layers"][i][t][1]))
    a, b = tree["layers"][0]["qkv"]
    x = np.random.default_rng(1).normal(
        size=(1, 1, cfg.hidden_size)).astype(np.float32)
    got = tten.lora_delta(torch.from_numpy(x), a, b,
                          torch.tensor([1])).numpy()
    ref = x @ st.tensors["layers.0.qkv.a"] \
        @ st.tensors["layers.0.qkv.b"] * 2.0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)

    bank = banks["port"]
    bank.load("u", tten.init_adapter_state(cfg, 8, seed=4))
    before = {k: v.copy() for k, v in bank._a.items()}
    version = bank.version
    bad = tten.init_adapter_state(cfg, 8, seed=5)
    bad.tensors["layers.0.qkv.a"] = np.zeros((7, 8), np.float32)
    with pytest.raises(ValueError, match="shapes"):
        bank.load("t", bad)
    missing = tten.init_adapter_state(cfg, 8, seed=5)
    del missing.tensors["layers.1.fc2.b"]
    with pytest.raises(ValueError, match="missing"):
        bank.load("t", missing)
    with pytest.raises(ValueError, match="exceeds bank"):
        bank.load("t", tten.init_adapter_state(cfg, 9, seed=5))
    with pytest.raises(ValueError, match="full"):
        bank.load("v", tten.init_adapter_state(cfg, 8, seed=5))
    assert bank.version == version
    for k, v in before.items():
        np.testing.assert_array_equal(bank._a[k], v)
    idx = bank.drop("t")
    assert bank.slot_of("t") == 0 and np.all(bank._a[(0, "qkv")][idx] == 0)
    assert bank.load("v", tten.init_adapter_state(cfg, 8, seed=5)) == idx


# -------------------------------------------------------- engine streams
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_mixed_tenant_streams_match_jax(models, kind):
    """One batch, a tenant and the base model: the port's rows are the
    JAX engine's with the same bank, token for token; the base row is the
    bank-less engine's, the tenant's row differs from it."""
    got, _ = _mixed_rows("port", models, kind)
    want, _ = _mixed_rows("jax", models, kind)
    plain, _ = _mixed_rows("port", models, kind, bank=False, bind=False)
    assert got == want
    assert got[0] == plain[0] and got[1] != plain[1]


def test_all_base_bank_matches_no_bank(models):
    """A bank no slot is bound to adds an exact zero: the streams are the
    bank-less engine's (and the JAX engine's), and a rebind to base
    mid-stream returns to them."""
    got, eng = _mixed_rows("port", models, bind=False)
    plain, _ = _mixed_rows("port", models, bank=False, bind=False)
    want, _ = _mixed_rows("jax", models, bind=False)
    assert got == plain == want
    bound, eng = _mixed_rows("port", models, steps=3)
    eng.set_slot_adapter(1, 0)
    assert eng.slot_adapter(1) == 0
    eng.reset_slot(0)
    assert eng.slot_adapter(0) == 0


def test_int8_weights_compose_with_the_delta_in_float(models):
    """int8 decode weights: the base row is the bank-less int8 engine's,
    the tenant's row differs from it, and both rows are the JAX int8
    engine's with the same bank."""
    got, _ = _mixed_rows("port", models, weight_dtype="int8", steps=6)
    want, _ = _mixed_rows("jax", models, weight_dtype="int8", steps=6)
    plain, _ = _mixed_rows("port", models, bank=False, bind=False,
                           weight_dtype="int8", steps=6)
    assert got == want
    assert got[0] == plain[0] and got[1] != plain[1]


def test_spec_adapter_stream_matches_one_token_loop(models):
    """The verify window adds each slot's delta over its gamma+1 rows, so
    the speculative engine's adapted stream is the one-token adapted
    loop's (the JAX engine's too)."""
    jm, _ = models
    one, _ = _mixed_rows("port", models, steps=9)
    spec = _engine("port", models, "spec", gamma=3, draft_layers=1)
    spec.attach_adapters(_bank("port", jm.cfg))
    rows = [[spec.prefill(s, _prompt(3 + s, 6 + 5 * s))] for s in range(2)]
    spec.set_slot_adapter(1, spec.adapter_bank.slot_of("acme"))
    while min(len(r) for r in rows) < 10:
        toks, n_emit = spec.decode_many()
        for s in range(2):
            rows[s].extend(int(t) for t in toks[s, :int(n_emit[s])])
    assert [r[:10] for r in rows] == one
    assert one == _mixed_rows("jax", models, steps=9)[0]


class _RecordingExecutables(graphs.Executables):
    """The CUDA-graph bookkeeping on the CPU: the first run of a name (or
    the first after `invalidate`) counts as its capture; every run is
    eager."""

    def run(self, name, fn, inputs, safe=None, upload=True, device=None):
        if name not in self._graphs:
            self.capture_counts[name] = self.capture_counts.get(name, 0) + 1
            self._graphs[name] = True
        inputs.upload()
        return fn(), 0


def _capture_sequence(pkg, models, kind, attach):
    """decode, (attach), bind, swap, drop, decode... -> the decode (and
    verify) compile counts: the JAX traces or the port's captures."""
    jm, _ = models
    eng = _engine(pkg, models, kind, **({"gamma": 2} if kind == "spec"
                                        else {}))
    if pkg == "port":
        eng._exe = _RecordingExecutables(eng.device)
    step = eng.decode_many if kind == "spec" else eng.decode
    if attach == "before":
        eng.attach_adapters(_bank(pkg, jm.cfg))
    for s in range(2):
        eng.prefill(s, _prompt(20 + s, 9))
    step()
    if attach == "after":
        eng.attach_adapters(_bank(pkg, jm.cfg))
    step()
    if attach != "never":
        eng.set_slot_adapter(1, 1)
        step()
        eng.swap_adapter("beta", jten.init_adapter_state(jm.cfg, 4, seed=2))
        eng.set_slot_adapter(0, 2)
        step()
        eng.drop_adapter("acme")
        step()
    names = ["decode"] + (["spec_verify"] if kind == "spec" else [])
    counts = eng.trace_counts if pkg == "jax" else eng.capture_counts
    return [counts.get(n, 0) for n in names]


@pytest.mark.parametrize("kind", ["paged", "spec"])
@pytest.mark.parametrize("attach", ["never", "before", "after"])
def test_capture_counts_match_jax_trace_counts(models, kind, attach):
    """A bank attached before the first decode: one capture; attached
    after it: one more, as JAX retraces once; binds, swaps and drops
    capture nothing; no bank: today's single capture."""
    got = _capture_sequence("port", models, kind, attach)
    assert got == _capture_sequence("jax", models, kind, attach)
    # the one-token engine's decode; the speculative engine's verify
    assert got[-1] == (2 if attach == "after" else 1)


# -------------------------------------------------------------- registry
@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_registry_round_trip_and_torn_commit(models, publisher, tmp_path):
    """What one package's registry publishes the other resolves (tensors,
    rank, alpha); a torn newest version falls back with a warning, and
    with every version torn the tenant gets base weights (None)."""
    import glob
    jm, _ = models
    other = "port" if publisher == "jax" else "jax"
    pub = PKG[publisher]["ten"].AdapterRegistry(str(tmp_path))
    res = PKG[other]["ten"].AdapterRegistry(str(tmp_path))
    st1 = jten.init_adapter_state(jm.cfg, 2, seed=1, alpha=4.0)
    pub.publish("acme", st1)
    out = res.resolve("acme")
    assert out.rank == 2 and out.alpha == 4.0
    for k, v in st1.tensors.items():
        np.testing.assert_array_equal(out.tensors[k], v)
    p2 = pub.publish("acme", jten.init_adapter_state(jm.cfg, 2, seed=2))
    npy = sorted(glob.glob(os.path.join(p2, "*.npy")))[0]
    with open(npy, "r+b") as f:
        f.truncate(os.path.getsize(npy) // 2)
    with pytest.warns(RuntimeWarning, match="falling back"):
        out = res.resolve("acme")
    np.testing.assert_array_equal(out.tensors["layers.0.qkv.a"],
                                  st1.tensors["layers.0.qkv.a"])
    for npy in glob.glob(os.path.join(tmp_path, "acme", "*", "*.npy")):
        with open(npy, "r+b") as f:
            f.truncate(0)
    with pytest.warns(RuntimeWarning, match="serving base weights"):
        assert res.resolve("acme") is None
    assert res.resolve("nobody") is None


# ------------------------------------------------------------- scheduler
def _sched(pkg, eng, **kw):
    if pkg == "port":
        kw["device"] = "cpu"
    return PKG[pkg]["sched"].Scheduler(eng, **kw)


def _swap_scenario(pkg, models, monkeypatch):
    jm, _ = models
    monkeypatch.setattr(PKG[pkg]["sched"].Request, "_ids",
                        itertools.count())
    eng = _engine(pkg, models)
    eng.attach_adapters(PKG[pkg]["ten"].AdapterBank(jm.cfg, 3, 4))
    sched = _sched(pkg, eng, max_queue=8)
    sched.schedule_adapter_swap(
        "acme", jten.init_adapter_state(jm.cfg, 4, seed=1, scale=1.0))
    sched.schedule_adapter_swap(
        "beta", jten.init_adapter_state(jm.cfg, 4, seed=2, scale=1.0))
    sched.step()
    out = [dict(sched.last_adapter_swap)]

    def run(tenant, p, **kw):
        h = sched.submit(p, max_new_tokens=5, tenant=tenant, **kw)
        sched.run_until_idle()
        return list(h.tokens), h.adapter_id

    pa, pb, pc = _prompt(13, 6), _prompt(14, 7), _prompt(15, 8)
    out += [run("acme", pa), run("beta", pb), run(None, pc),
            run(None, pc, adapter_id="acme")]
    failed0 = _counter(pkg, "serving_adapter_swaps_total{status=failed}")
    PKG[pkg]["faults"].arm("serving.adapter_swap", "raise")
    ev = sched.schedule_adapter_swap(
        "acme", jten.init_adapter_state(jm.cfg, 4, seed=9, scale=1.0))
    sched.step()
    PKG[pkg]["faults"].disarm_all()
    out += [ev.swap_result["ok"], "FaultInjected" in ev.swap_result["error"],
            _counter(pkg, "serving_adapter_swaps_total{status=failed}")
            - failed0, run("acme", pa), run("beta", pb)]
    bad = jten.init_adapter_state(jm.cfg, 4, seed=9, scale=1.0)
    del bad.tensors["layers.0.qkv.a"]
    ev2 = sched.schedule_adapter_swap("acme", bad)
    sched.step()
    out += [ev2.swap_result["ok"], run("acme", pa)]
    ev3 = sched.schedule_adapter_swap(
        "acme", jten.init_adapter_state(jm.cfg, 4, seed=9, scale=1.0))
    sched.step()
    out += [ev3.swap_result, run("acme", pa), run("beta", pb)]
    return out, [{k: v for k, v in r.items() if k not in ("t",
                                                          "trace_id")}
                 for r in sched.decision_records() if r["action"] == "swap"]


def test_adapter_swap_and_its_chaos_match_jax(models, monkeypatch):
    """`schedule_adapter_swap` applies between steps; a tenant's requests
    decode under its adapter (`adapter_id` on the handle), base traffic
    under the base weights, and an explicit `adapter_id` binds that
    adapter. A `serving.adapter_swap` fault and a bank validation failure
    keep the old adapter serving bit for bit and tick the failed count; a
    later swap changes only its tenant's rows. All as the JAX scheduler,
    swap decision records included."""
    got, grec = _swap_scenario("port", models, monkeypatch)
    want, wrec = _swap_scenario("jax", models, monkeypatch)
    assert got == want and grec == wrec
    (acme, aid), (beta, _), (base, bid), (forced, fid) = got[1:5]
    assert (aid, bid, fid) == ("acme", None, "acme")
    assert got[5:8] == [False, True, 1.0]
    assert got[8] == (acme, aid) and got[9] == (beta, "beta")
    assert got[10] is False and got[11] == (acme, aid)
    assert got[13] != (acme, aid) and got[14] == (beta, "beta")


def _one_block_entry(cache, pool, seed, namespace):
    bs = cache.block_size
    prompt = _prompt(seed, bs + 1)
    row = pool.alloc(1)
    cache.insert(prompt, row, bs, namespace=namespace)
    pool.unref(row[0])
    return prompt


def _namespace_scenario(cache_cls, pool_cls):
    pool = pool_cls(num_blocks=32, block_size=4)
    cache = cache_cls(pool, 4)
    cache.set_quotas({"a": 2, "b": 2})
    shared = _one_block_entry(cache, pool, 20, "a")
    out = [cache.match(shared, namespace="a")[1],
           cache.match(shared, namespace="b"), cache.match(shared)]
    _one_block_entry(cache, pool, 21, "a")
    for seed in (22, 23, 24):
        _one_block_entry(cache, pool, seed, "b")
    out += [cache.resident("a"), cache.resident("b"),
            cache.evict(2, requester="b"), cache.resident("b"),
            cache.evict(4, requester="b"), cache.resident("a")]
    _one_block_entry(cache, pool, 25, "a")
    out += [cache.evict(4, requester="b"), cache.resident("a"),
            cache.namespace_evictions(), cache.namespace_residents(),
            sorted(cache._entries)]
    return out


def test_namespace_isolation_and_quota_eviction_match_jax():
    """Namespaced keys never share; a requester drains its own namespace
    first and cannot touch a foreign one within its quota; an over-quota
    foreign namespace drains down to its quota: as the JAX cache does,
    entry for entry."""
    got = _namespace_scenario(PrefixCache, BlockPool)
    assert got == _namespace_scenario(JPrefixCache, JBlockPool)
    assert got[:3] == [4, ([], 0), ([], 0)]
    assert got[-3] == {"b": 3, "a": 1} and got[-2] == {"a": 2}


def test_engine_namespaces_isolate_tenants(models):
    """Through the paged engine: one prompt shares its blocks within a
    namespace and never across, as in the JAX engine."""
    out = {}
    for pkg in PKG:
        eng = _engine(pkg, models, num_blocks=24)
        prompt = _prompt(30, 16) + [1, 2, 3]
        eng.prefill(0, prompt, namespace="a")
        used = eng.block_pool.in_use
        eng.prefill(1, prompt, namespace="a")
        same = eng.block_pool.in_use - used
        eng.reset_slot(1)
        eng.prefill(1, prompt, namespace="b")
        out[pkg] = (same, eng.block_pool.in_use - used,
                    eng.prefix_cache.resident("a"))
    assert out["port"] == out["jax"] and out["port"][0] < out["port"][1]


def test_token_bucket_under_a_fixed_clock():
    """Refill from clock deltas, capped at the burst, as the JAX bucket."""
    seq = []
    for ten in (tten, jten):
        t = [0.0]
        b = ten.TokenBucket(rate=10.0, burst=20.0, clock=lambda: t[0])
        row = [b.available()]
        b.take(15.0)
        row.append(b.available())
        t[0] = 1.0
        row.append(b.available())
        t[0] = 10.0
        row.append(b.available())
        seq.append(row)
    assert seq[0] == seq[1] == [20.0, 5.0, 15.0, 20.0]
    cfg = tten.TenancyConfig(tenants={"x": tten.TenantSpec()})
    assert cfg.buckets(lambda: 0.0) == {} and cfg.quotas() == {}
    assert cfg.namespace_of("x") is None and cfg.adapter_slots == 2


def _rate_scenario(pkg, models, monkeypatch, tmp_path):
    jm, _ = models
    mod = PKG[pkg]["sched"]
    monkeypatch.setattr(mod.Request, "_ids", itertools.count())
    t = [0.0]
    eng = _engine(pkg, models)
    eng.attach_adapters(_bank(pkg, jm.cfg))
    ten = PKG[pkg]["ten"]
    tenancy = ten.TenancyConfig(tenants={
        "acme": ten.TenantSpec(namespace="ns-acme", kv_block_quota=4,
                               rate_tokens_per_s=10.0, burst_tokens=20.0)})
    path = str(tmp_path / f"{pkg}.jsonl")
    sched = _sched(pkg, eng, max_queue=8, clock=lambda: t[0],
                   tenancy=tenancy, metrics_path=path, shed_watermark=2)
    limited0 = _counter(pkg, "serving_rate_limited_total{tenant=acme}")
    out, handles = [], []
    handles.append(sched.submit(_prompt(40, 8), max_new_tokens=2,
                                tenant="acme"))
    handles.append(sched.submit(_prompt(41, 8), max_new_tokens=2,
                                tenant="acme"))
    for seed in (42, 44):
        with pytest.raises(mod.RateLimitedError, match="rate limited"):
            sched.submit(_prompt(seed, 8), max_new_tokens=2, tenant="acme")
    # past the shed watermark a batch request sheds; acme's bucket still
    # denies first
    with pytest.raises(mod.LoadShedError):
        sched.submit(_prompt(43, 8), max_new_tokens=2, priority="batch")
    t[0] = 1.0
    handles.append(sched.submit(_prompt(45, 8), max_new_tokens=2,
                                tenant="acme"))
    while any(not h.done() for h in handles):
        sched.step()
        t[0] += 0.001
    sched.close()
    out.append(_counter(pkg, "serving_rate_limited_total{tenant=acme}")
               - limited0)
    out.append([(h.status, h.tokens, h.adapter_id, h.prefix_namespace,
                 h.rate_limited) for h in handles])
    out.append(eng.prefix_cache._quotas)
    recs = [json.loads(line) for line in open(path)]
    out.append([{k: v for k, v in r.items() if k != "trace_id"}
                for r in recs if r.get("kind") == "request"
                or r.get("action") in ("rate_limit", "shed", "admit")])
    return out, sched.decision_records()


def test_rate_limit_ahead_of_shed_matches_jax(models, monkeypatch,
                                              tmp_path):
    """The tenant's bucket denies before the shed rule: RateLimitedError
    (a QueueFullError), `serving_rate_limited_total{tenant}` +1 a denial,
    a `rate_limit` decision record whose inputs replay to the denial;
    refill admits again. Handles carry the tenant's adapter and
    namespace; decision and request records (`adapter_id`,
    `prefix_namespace`, `rate_limited`) are the JAX scheduler's field for
    field."""
    from paddle_tpu_torch.observability import decisions
    got, recs = _rate_scenario("port", models, monkeypatch, tmp_path)
    want, _ = _rate_scenario("jax", models, monkeypatch, tmp_path)
    assert got == want
    assert got[0] == 2.0
    assert [h[2:] for h in got[1]] == [("acme", "ns-acme", False)] * 3
    assert got[2] == {"ns-acme": 4}
    rl = [r for r in recs if r["action"] == "rate_limit"]
    assert len(rl) == 2 and rl[0]["inputs"]["cost"] == 10
    assert decisions.replay_rate_limit(rl[0]["inputs"]) is not None
    assert decisions.validate_records(recs) == []
    denied = [r for r in got[3] if r.get("rate_limited")]
    assert len(denied) == 2 and all(r["status"] == "SHED" for r in denied)
    assert issubclass(tsched.RateLimitedError, tsched.QueueFullError)
