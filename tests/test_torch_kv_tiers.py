"""The port's KV tiers (`paddle_tpu_torch.serving.kv_tiers` and the paged
engine's `enable_kv_tiers`) against the JAX package, on the CPU.

The JAX tiny GPT (hidden 128, 2 layers, 4 heads, vocab 1024) is built from
a fixed seed and its weights are carried into the port with
`load_jax_params`; the JAX engines run the gather path, the port its
default kernel path (the kernel's plain version on the CPU). Then:

  * the host tier's int8 requantization writes the JAX tier's codes and
    scales bit for bit, and both decode them to the same floats;
  * a disk log written by either package opens, restores, recovers from a
    torn tail and compacts in the other; the port's tier holds the
    reference's torn-tail, bit-rot and compaction contract;
  * evict-and-resubmit through the `Scheduler`: the promoted chain's
    stream equals the JAX engine's over the same sequence, token for
    token (f32 and int8 pools), with the same promoted blocks, the same
    `tier_restore` count and the same `serving_kv_tier_*` counter deltas,
    and the pools keep their storage across the restore;
  * the int8 host tier and its disk cascade give the JAX engine's streams;
  * the `serving.kv_spill` and `serving.kv_restore` sites degrade to a
    recompute with the untiered stream in both packages;
  * the two-pass quota eviction spills in the JAX cache's order.
"""
import os

import numpy as np
import pytest

import paddle_tpu
from paddle_tpu.observability import faults as jfaults
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.serving import PagedGenerationEngine as JPagedEngine
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving.kv_tiers import DiskTier as JDiskTier
from paddle_tpu.serving.kv_tiers import HostTier as JHostTier
from paddle_tpu.text.models import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.observability import faults as tfaults
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.serving import (PagedGenerationEngine, Scheduler,
                                      ServingConfig)
from paddle_tpu_torch.serving.kv_tiers import DiskTier, HostTier
from paddle_tpu_torch.text.models import gpt_tiny
from paddle_tpu_torch.text.models.convert import load_jax_params

ENGINE = dict(slots=2, max_len=64, block_size=8)
TIERS = dict(enable_kv_tiers=True, host_tier_blocks=16)
FAMILIES = ("serving_kv_tier_hits_total", "serving_kv_tier_misses_total",
            "serving_kv_tier_demote_total", "serving_kv_tier_promote_total",
            "serving_kv_tier_drop_total", "serving_kv_tier_corrupt_total")


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
    return np.random.RandomState(seed).randint(0, 1000, n).tolist()


def _engine(pkg, models, **kw):
    jm, tm = models
    if pkg == "jax":
        return JPagedEngine(jm, attention_impl="gather", **ENGINE, **kw)
    return PagedGenerationEngine(tm, device="cpu", **ENGINE, **kw)


def _sched(pkg, eng, max_new):
    if pkg == "jax":
        return JScheduler(eng, JServingConfig(default_max_new_tokens=max_new))
    return Scheduler(eng, ServingConfig(default_max_new_tokens=max_new),
                     device="cpu")


def _run(sched, prompt):
    h = sched.submit(prompt)
    sched.run_until_idle()
    assert h.status == "DONE", (h.status, h.error)
    return list(h.tokens)


def _counters(pkg):
    mod = jmetrics if pkg == "jax" else tmetrics
    flat = mod.flatten_snapshot(mod.registry().snapshot(),
                                kinds=("counter",))
    return {k: v for k, v in flat.items() if k.startswith(FAMILIES)}


def _delta(before, after):
    return {k: after.get(k, 0.0) - before.get(k, 0.0)
            for k in set(before) | set(after)
            if after.get(k, 0.0) != before.get(k, 0.0)}


def _block_rec(seed, bs=8, heads=4, dim=32, layers=2):
    """One pool-native f32 block record as the engines' readers produce
    it: [block_size, heads, head_dim] per layer and side."""
    r = np.random.RandomState(seed)
    arrays = {}
    for li in range(layers):
        for side in ("k", "v"):
            a = r.randn(bs, heads, dim).astype(np.float32)
            a[:, 1] *= 40.0               # heads of different scales
            arrays[f"{side}{li}"] = a
    return {"ns": "t", "parent": None, "quant": False, "arrays": arrays}


# ------------------------------------------------------------- host tier
def test_host_tier_int8_codes_bit_equal_to_jax():
    """The int8 host tier requantizes each [bs, heads, dim] array against
    its per-head abs-max with the canonical pair: the port's codes and
    scales are the JAX tier's bit for bit, both decode to the same
    floats, and LRU overflow surfaces the same keys."""
    jt, tt = JHostTier(2, "int8"), HostTier(2, "int8")
    for i, key in enumerate(("a", "b", "c")):
        rec = _block_rec(i)
        jt.put(key, rec)
        tt.put(key, rec)
        jraw, traw = jt.raw(key), tt.raw(key)
        assert sorted(jraw["arrays"]) == sorted(traw["arrays"])
        for name, arr in jraw["arrays"].items():
            got = traw["arrays"][name]
            assert got.dtype == np.asarray(arr).dtype, name
            np.testing.assert_array_equal(got, np.asarray(arr), name)
        assert tt.last_put_saturation == jt.last_put_saturation
    jd, td = jt.get("c"), tt.get("c")
    for name, arr in jd["arrays"].items():
        np.testing.assert_array_equal(td["arrays"][name], arr)
    assert [k for k, _ in tt.overflow()] == [k for k, _ in jt.overflow()]
    assert tt.keys() == jt.keys()
    # float32 mode stores the arrays as they are
    tf = HostTier(4, "float32")
    rec = _block_rec(5)
    tf.put("x", rec)
    for name, arr in rec["arrays"].items():
        np.testing.assert_array_equal(tf.get("x")["arrays"][name], arr)


# ------------------------------------------------------------- disk tier
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_disk_log_cross_opens(writer, tmp_path):
    """A log one package writes (f32 records, an int8 host tier's
    requantized record, a torn tail) opens in the other: the same keys,
    the torn tail truncated, every record restored bit for bit (sha256
    checked), and a compaction by the reader keeps what a reopen by the
    writer reads."""
    W, R = (JDiskTier, DiskTier) if writer == "jax" else (DiskTier,
                                                         JDiskTier)
    H = JHostTier if writer == "jax" else HostTier
    d = str(tmp_path / "kvt")
    w = W(d, capacity_blocks=8, compact_threshold=0.5)
    recs = {f"key{i}": _block_rec(i) for i in range(3)}
    q8 = H(1, "int8")
    q8.put("q", _block_rec(9))
    recs["q8"] = q8.raw("q")
    for k, r in recs.items():
        assert w.put(k, r)
    assert not w.put("torn", _block_rec(7), torn=True)
    r = R(d, capacity_blocks=8, compact_threshold=0.5)
    assert sorted(r.keys()) == sorted(recs)
    assert r.recovered_torn_bytes > 0
    for k, rec in recs.items():
        got, corrupt = r.get(k)
        assert not corrupt
        assert got["ns"] == rec["ns"] and got["quant"] == rec["quant"]
        for name, arr in rec["arrays"].items():
            np.testing.assert_array_equal(got["arrays"][name], arr)
    # drops past the threshold compact the log; the writer reopens it
    assert r.drop("key0") and r.drop("key1")
    r.compact()
    assert r.dead_fraction() == 0.0
    w2 = W(d, capacity_blocks=8, compact_threshold=0.5)
    assert sorted(w2.keys()) == ["key2", "q8"]
    got, corrupt = w2.get("q8")
    assert not corrupt
    for name, arr in recs["q8"]["arrays"].items():
        np.testing.assert_array_equal(got["arrays"][name], arr)


def test_disk_tier_torn_tail_bit_rot_and_compaction(tmp_path):
    """The reference's contract on the port's tier: a torn append is
    never indexed and later appends go over it, a reopen truncates a torn
    tail and keeps every intact record, a flipped payload byte is a
    verified corrupt miss, and compaction keeps only the live records."""
    d = str(tmp_path / "kvt")
    t = DiskTier(d, capacity_blocks=8, compact_threshold=0.5)
    recs = {f"key{i}": _block_rec(i) for i in range(3)}
    for k, r in recs.items():
        assert t.put(k, r)
    assert not t.put("torn", _block_rec(9), torn=True)
    assert "torn" not in t
    assert t.put("key3", _block_rec(3))
    assert not t.put("torn2", _block_rec(10), torn=True)
    t2 = DiskTier(d, capacity_blocks=8, compact_threshold=0.5)
    assert sorted(t2.keys()) == ["key0", "key1", "key2", "key3"]
    assert t2.recovered_torn_bytes > 0
    with open(t2.path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    got, corrupt = t2.get("key3")
    assert got is None and corrupt and "key3" not in t2
    t3 = DiskTier(str(tmp_path / "kvt2"), capacity_blocks=2,
                  compact_threshold=0.9)
    for i in range(5):
        assert t3.put(f"c{i}", _block_rec(i))
        t3.enforce_capacity()
    size = os.path.getsize(t3.path)
    t3.compact()
    assert os.path.getsize(t3.path) < size and t3.dead_fraction() == 0.0
    assert sorted(t3.keys()) == ["c3", "c4"]
    for k in t3.keys():
        got, corrupt = t3.get(k)
        assert got is not None and not corrupt


# ------------------------------------------------------ engine restores
def _evict_and_resubmit(pkg, models, prompt, max_new, **kw):
    """Serve `prompt`, evict every cached block into the tiers, serve it
    again. Returns (warm stream, restored stream, engine, counter deltas
    of the resubmission, tier residency after the eviction)."""
    eng = _engine(pkg, models, **dict(TIERS, **kw))
    sched = _sched(pkg, eng, max_new)
    warm = _run(sched, prompt)
    assert eng.prefix_cache.evict(999) == (len(prompt) - 1) // 8
    residency = eng.kv_tiers.residency()
    before = _counters(pkg)
    again = _run(sched, prompt)
    return warm, again, eng, _delta(before, _counters(pkg)), residency


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_tiered_restore_matches_jax(models, kv_dtype):
    """Evict, demote, resubmit: the port's promoted chain streams what the
    JAX engine's does over the same sequence (and what the warm run
    streamed), with the same promoted blocks, the same `tier_restore`
    count and the same tier counter deltas. The untiered engine has no
    `tier_restore` entry; the restore writes the pools in place."""
    prompt = _prompt(40, 26)                 # 3 full blocks + a tail
    out = {}
    for pkg in ("jax", "port"):
        eng0 = _engine(pkg, models, kv_dtype=kv_dtype)
        assert "tier_restore" not in eng0.trace_counts
        assert eng0.kv_tiers is None
        oracle = _run(_sched(pkg, eng0, 6), prompt)
        warm, again, eng, delta, res = _evict_and_resubmit(
            pkg, models, prompt, 6, kv_dtype=kv_dtype)
        assert warm == oracle and again == warm, pkg
        assert sorted(res.values()) == ["host"] * 3
        assert eng.kv_tiers.residency() == {}
        assert eng.trace_counts["tier_restore"] == 1
        assert eng.last_prefill_stats["tier_promoted_blocks"] == 3
        assert eng.last_prefill_stats["tier_restore_s"] > 0
        out[pkg] = (again, sorted(res), delta)
        if pkg == "port":
            ptrs = [x.data_ptr() for layer in eng._pool for x in layer]
            eng.prefix_cache.evict(999)
            _run(_sched(pkg, eng, 6), prompt)
            assert [x.data_ptr() for layer in eng._pool
                    for x in layer] == ptrs
    assert out["port"] == out["jax"]


def test_int8_host_tier_and_disk_cascade_match_jax(models, tmp_path):
    """An int8 host tier of one block cascades the two colder blocks to
    disk as requantized records; the promoted mixed-tier chain gives the
    JAX engine's stream (>= 0.9 agreement with the warm f32 run, the
    reference's bound), with the same residency and counter deltas."""
    prompt = _prompt(48, 26)
    out = {}
    for pkg in ("jax", "port"):
        warm, again, eng, delta, res = _evict_and_resubmit(
            pkg, models, prompt, 10, host_tier_dtype="int8",
            host_tier_blocks=1, disk_tier_dir=str(tmp_path / pkg))
        assert sorted(res.values()) == ["disk", "disk", "host"]
        agree = sum(a == b for a, b in zip(warm, again)) / len(warm)
        assert agree >= 0.9, (pkg, warm, again)
        out[pkg] = (again, sorted(res.items()), delta)
    assert out["port"] == out["jax"]
    assert out["port"][2]["serving_kv_tier_promote_total{tier=disk}"] == 2


def test_chaos_spill_and_restore_degrade_to_recompute(models, tmp_path):
    """Truncate at `serving.kv_spill` loses every spilled entry, truncate
    at `serving.kv_restore` drops the chain's head and counts one
    corruption; in both the resubmitted stream is the untiered one, and
    the port's residency and counter deltas are the JAX engine's."""
    prompt = _prompt(42, 26)
    out = {}
    for pkg, fz in (("jax", jfaults), ("port", tfaults)):
        eng = _engine(pkg, models, **TIERS,
                      disk_tier_dir=str(tmp_path / pkg))
        sched = _sched(pkg, eng, 4)
        t1 = _run(sched, prompt)
        before = _counters(pkg)
        fz.arm("serving.kv_spill", mode="truncate", nth=1)
        assert eng.prefix_cache.evict(999) == 3
        fz.disarm_all()
        assert eng.kv_tiers.residency() == {}
        assert _run(sched, prompt) == t1
        spill = _delta(before, _counters(pkg))
        assert eng.prefix_cache.evict(999) == 3
        before = _counters(pkg)
        fz.arm("serving.kv_restore", mode="truncate", nth=1)
        assert _run(sched, prompt) == t1
        fz.disarm_all()
        restore = _delta(before, _counters(pkg))
        assert restore["serving_kv_tier_corrupt_total"] == 1
        assert len(eng.kv_tiers.residency()) == 2
        assert eng.trace_counts.get("tier_restore", 0) == 0
        out[pkg] = (t1, spill, restore, sorted(eng.kv_tiers.residency()))
    assert out["port"] == out["jax"]


def test_quota_spill_order_matches_jax(models):
    """The two-pass eviction decides what demotes: the requester's own
    namespace spills first and a foreign namespace within its quota keeps
    its chain in the pool, in the JAX cache's order, key for key."""
    pa, pb = _prompt(43, 26), _prompt(44, 26)
    out = {}
    for pkg in ("jax", "port"):
        eng = _engine(pkg, models, **TIERS)
        eng.prefill(0, pa, namespace="a")
        eng.reset_slot(0)
        eng.prefill(0, pb, namespace="b")
        eng.reset_slot(0)
        eng.prefix_cache.set_quota("a", 3)
        steps = [eng.prefix_cache.evict(2, requester="b"),
                 list(eng.kv_tiers.residency()),
                 eng.prefix_cache.evict(10, requester="b"),
                 list(eng.kv_tiers.residency()),
                 [eng.kv_tiers.host.raw(k)["ns"]
                  for k in eng.kv_tiers.residency()],
                 eng.prefix_cache.resident("a"),
                 eng.prefix_cache.namespace_evictions()]
        eng.prefill(0, pa, namespace="a")
        steps.append((eng.last_prefill_stats["prefix_hit_tokens"],
                      eng.last_prefill_stats["tier_promoted_blocks"]))
        out[pkg] = steps
    assert out["port"] == out["jax"]
    assert out["port"][0] == 2 and out["port"][2] == 1
    assert out["port"][4] == ["b", "b", "b"]
    assert out["port"][-1] == (24, 0)
