"""The port's numerics health plane (`paddle_tpu_torch.observability.
numerics` and its taps in the engines) against the JAX package, on the CPU.

The JAX tiny GPT (hidden 128, 2 layers, 4 heads, vocab 1024) is built from
a fixed seed and its weights are carried into the port with
`load_jax_params`; the JAX engines run the gather path, the port its
default kernel path (the kernel's plain version on the CPU). On the CPU
the port's executables run eagerly; their captures are counted by a
recording stand-in for the CUDA graphs (the first run of a name counts).
Then:

  * `stats_vector`, `tree_stats_vector`, `np_stats` and `np_tree_stats`
    equal the JAX functions on the same arrays (float with NaN and inf,
    int8 codes with the 127 threshold, mixed lists): finite_frac, absmax
    and sat_frac exactly, rms to rtol 1e-6;
  * `tap` without a sink touches nothing; `tap_layer` fires only under a
    layer filter; the monitor latches the three kinds and extends its
    baseline only on healthy values, as the JAX monitor does on the same
    sequence; `bisect_first_unhealthy` is O(log n);
  * arming per kind (dense, paged, speculative): a disarmed engine's
    streams and capture counts equal an armed one's, the monitor reads
    zero, and the armed stats of the logits equal the JAX engine's
    within the serving tests' logits tolerance (atol 1e-4); on int8 KV
    and int8 weights the sites `decode.logits`, `kv.codes`, `kv.scale`,
    `weights.q` and `weights.scale` are there, held to the JAX engine's;
  * the NaN drill: `numerics.corrupt` poisons `blocks.1.ln1.weight`; the
    anomaly latches in the same step, the localizer names layer 1 as the
    JAX localizer does, the bundle is on disk, `decode` is captured once
    and the probes count apart; the probes leave the pool as the live
    step left it; the prefill masters stay finite, and a fresh engine
    shows zero anomalies;
  * the `scale_zero` drill latches `weights.scale:drift`;
  * the host tier's int8 requantization feeds the process monitor, and
    the ledger's `tier_demote` carries its saturation into
    `tools/serve_report.py`'s residency join.

The tensor- and pipeline-parallel engine kinds are held in
`tests/test_torch_pp.py`. Left out: the eager optimizer's taps (A.13).
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.observability import faults as jfaults
from paddle_tpu.observability import numerics as jnum
from paddle_tpu.serving import GenerationEngine as JGenerationEngine
from paddle_tpu.serving import PagedGenerationEngine as JPagedEngine
from paddle_tpu.serving import SpeculativeEngine as JSpeculativeEngine
from paddle_tpu.text.models import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.observability import faults as tfaults
from paddle_tpu_torch.observability import flight_recorder as tfr
from paddle_tpu_torch.observability import kvledger as tkvl
from paddle_tpu_torch.observability import numerics as tnum
from paddle_tpu_torch.serving import (GenerationEngine,
                                      PagedGenerationEngine,
                                      SpeculativeEngine, graphs)
from paddle_tpu_torch.serving.kv_tiers import HostTier
from paddle_tpu_torch.text.models import gpt_tiny
from paddle_tpu_torch.text.models.convert import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import serve_report  # noqa: E402

PROMPT = np.arange(1, 9, dtype=np.int32)
LOGITS_ATOL = 1e-4          # the serving tests' logits tolerance
POISON = "blocks.1.ln1.weight"


@pytest.fixture(scope="module")
def models():
    """(JAX tiny GPT, the port's tiny GPT on the CPU with its weights)."""
    paddle_tpu.seed(7)
    jm = jgpt_tiny()
    jm.eval()
    params = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, load_jax_params(gpt_tiny(device="cpu"), params)


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    """Faults disarmed and no process monitor around every test; both
    packages' postmortem bundles under the test's own directory."""
    monkeypatch.setenv("PADDLE_TPU_POSTMORTEM_DIR", str(tmp_path / "pm"))
    rec = tfr.get()
    prev_dir = rec.dir
    rec.dir = str(tmp_path / "pm")
    jfaults.disarm_all()
    tfaults.disarm_all()
    yield
    rec.dir = prev_dir
    jfaults.disarm_all()
    tfaults.disarm_all()
    tnum.set_monitor(None)


class _RecordingExecutables(graphs.Executables):
    """The CUDA-graph bookkeeping on the CPU: the first run of a name
    counts as its capture; every run is eager."""

    def run(self, name, fn, inputs, safe=None, upload=True, device=None):
        if name not in self._graphs:
            self.capture_counts[name] = self.capture_counts.get(name, 0) + 1
            self._graphs[name] = True
        inputs.upload()
        return fn(), 0


def _hold_vec(got, want, what):
    """A port stats vector held to a JAX one: the fractions and the
    absmax exactly, rms to rtol 1e-6."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.dtype == np.float32 and got.shape == (4,), what
    assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3], \
        (what, got, want)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, err_msg=what)


# ------------------------------------------------------------- stats math

def _arrays(seed):
    r = np.random.RandomState(seed)
    x = (r.randn(777) * 3).astype(np.float32)
    x[r.rand(777) < 0.02] = np.nan
    x[5] = np.inf
    x[9] = -np.inf
    codes = r.randint(-127, 128, (33, 17)).astype(np.int8)
    codes[0, :5] = 127
    return x, codes, r.randn(11, 3).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stats_equal_jax(seed):
    import jax
    import jax.numpy as jnp
    x, codes, small = _arrays(seed)
    cases = [(x, None), (x, 2.0), (codes, 127), (codes, None),
             (small, None), (np.asarray([1.0, -3.0, np.nan, 2.0],
                                        np.float32), None)]
    for arr, thr in cases:
        want = np.asarray(jax.jit(lambda a: jnum.stats_vector(a, thr))(
            jnp.asarray(arr)))
        _hold_vec(tnum.stats_vector(torch.from_numpy(arr), thr).numpy(),
                  want, ("stats_vector", arr.dtype, thr))
        np.testing.assert_array_equal(tnum.np_stats(arr, thr),
                                      jnum.np_stats(arr, thr))
    leaves = [x, codes, small]
    want = np.asarray(jnum.tree_stats_vector(
        [jnp.asarray(a) for a in leaves], 127))
    _hold_vec(tnum.tree_stats_vector(
        [torch.from_numpy(a) for a in leaves], 127).numpy(), want, "tree")
    np.testing.assert_array_equal(tnum.np_tree_stats(leaves, 127),
                                  jnum.np_tree_stats(leaves, 127))
    # the NaN is masked out of the magnitude channels
    vec = tnum.stats_vector(torch.tensor([1.0, -3.0, float("nan"), 2.0]))
    ff, absmax, rms, sat = (float(v) for v in vec)
    assert ff == pytest.approx(0.75) and absmax == 3.0 and sat == 0.0
    assert rms == pytest.approx(math.sqrt((1 + 9 + 0 + 4) / 4))


def test_int8_stats_make_no_float_copy():
    """The int8 path squares an int16 copy and sums in int64: exact where
    a float32 sum of squares would round."""
    codes = torch.full((1 << 16,), 127, dtype=torch.int8)
    codes[::2] = -126
    vec = tnum.stats_vector(codes, 127)
    n = codes.numel()
    want_rms = math.sqrt((127 ** 2 * (n // 2) + 126 ** 2 * (n // 2)) / n)
    assert float(vec[0]) == 1.0 and float(vec[1]) == 127.0
    assert float(vec[2]) == pytest.approx(want_rms, rel=1e-7)
    assert float(vec[3]) == 0.5


def test_tap_is_noop_without_sink():
    tnum.tap("anywhere", object())
    tnum.tap_layer(0, "act", object())
    tnum.tap_tree("anywhere", [object()])
    with tnum.sink_scope() as sink:
        tnum.tap("site", torch.ones(3))
    assert list(sink) == ["site"]
    with tnum.sink_scope() as sink:
        tnum.tap_layer(0, "act", torch.ones(3))
    assert not sink
    with tnum.sink_scope(layers=(1,)) as sink:
        tnum.tap_layer(0, "act", torch.ones(3))
        tnum.tap_layer(1, "act", torch.ones(3))
    assert list(sink) == ["layer1.act"]
    with tnum.sink_scope(layers="all") as sink:
        tnum.tap_tree("tree", {"a": [torch.ones(2)], "b": (torch.ones(3),)})
    assert float(sink["tree"][0]) == 1.0


def _monitor_script(mod):
    mon = mod.NumericsMonitor(min_history=3, auto_bundle=False)
    seen = [mon.observe("s", [1.0, 2.0, 1.0, 0.0]) for _ in range(4)]
    seen.append(mon.observe("s", [0.5, 2.0, 1.0, 0.0]))
    seen.append(mon.observe("s", [1.0, 2.0, 1.0, 0.9]))
    seen.append(mon.observe("s", [1.0, 2.0, 100.0, 0.0]))
    seen.append(mon.observe("s", [1.0, 2.0, 100.0, 0.0]))
    seen.append(mon.observe("s", [1.0, 2.0, 1.0, 0.0]))
    seen.append(mon.observe_sink({"b": np.ones(4, np.float32),
                                  "a": [np.nan, 0.0, 0.0, 0.0]}))
    return seen, mon.counts(), mon.total()


def test_monitor_latches_like_jax():
    got, want = _monitor_script(tnum), _monitor_script(jnum)
    assert got == want
    seen, counts, total = got
    assert seen[4:8] == [["nonfinite"], ["saturation"], ["drift"],
                         ["drift"]]
    assert seen[8] == []                 # the baseline did not move
    assert total == 6 and "s:drift" in counts


def test_monitor_bundles_once(tmp_path):
    mon = tnum.NumericsMonitor(min_history=3, auto_bundle=True)
    mon.observe("s", [0.5, 1.0, 1.0, 0.0])
    first = mon.bundle_path
    assert first and os.path.exists(first)
    mon.observe("s", [0.5, 1.0, 1.0, 0.0])
    assert mon.bundle_path == first and mon.total() == 2


def test_bisect_first_unhealthy():
    for n, pred in ((8, lambda k: k >= 3), (8, lambda k: True),
                    (8, lambda k: False), (0, lambda k: True)):
        assert tnum.bisect_first_unhealthy(n, pred) == \
            jnum.bisect_first_unhealthy(n, pred)
    calls = []
    assert tnum.bisect_first_unhealthy(
        1024, lambda k: (calls.append(k), k >= 700)[1]) == 700
    assert len(calls) <= 12


# ----------------------------------------------- arming across engine kinds

def _build(pkg, kind, models, taps, **kw):
    jm, tm = models
    base = dict(slots=2, max_len=64, numerics_taps=taps)
    if kind != "dense":
        base["block_size"] = 8
    if kind == "spec":
        base["gamma"] = 2
    base.update(kw)
    if pkg == "jax":
        if kind != "dense":
            base["attention_impl"] = "gather"
        cls = {"dense": JGenerationEngine, "paged": JPagedEngine,
               "spec": JSpeculativeEngine}[kind]
        return cls(jm, **base)
    cls = {"dense": GenerationEngine, "paged": PagedGenerationEngine,
           "spec": SpeculativeEngine}[kind]
    eng = cls(tm, device="cpu", **base)
    if kind != "dense":
        eng._exe = _RecordingExecutables(eng.device)
    return eng


def _drive(eng, kind):
    out = [eng.prefill(0, PROMPT)]
    for _ in range(3):
        if kind == "spec":
            toks, n = eng.decode_many()
            out.extend(int(x) for x in toks[0, :int(n[0])])
        else:
            out.append(int(eng.decode()[0]))
    return out


@pytest.mark.parametrize("kind", ["dense", "paged", "spec"])
def test_taps_disarmed_equal_armed_capture_once(kind, models):
    off = _build("port", kind, models, False)
    toks_off = _drive(off, kind)
    assert off.numerics_monitor is None and off.last_numerics is None
    on = _build("port", kind, models, True)
    toks_on = _drive(on, kind)
    assert toks_on == toks_off
    assert on.capture_counts == off.capture_counts
    assert on.trace_counts == off.trace_counts
    if kind != "dense":
        assert on.capture_counts["decode" if kind == "paged"
                                 else "spec_verify"] == 1
    assert on.numerics_monitor.total() == 0
    assert on.last_numerics, "armed engine ingested no sink"
    for site, st in on.last_numerics.items():
        assert st["finite_frac"] == 1.0, (site, st)
    # the same sites as the JAX engine, the logits' stats within the
    # serving tests' logits tolerance
    ref = _build("jax", kind, models, True)
    assert _drive(ref, kind) == toks_on
    assert set(on.last_numerics) == set(ref.last_numerics)
    for site, st in on.last_numerics.items():
        want = ref.last_numerics[site]
        assert st["finite_frac"] == want["finite_frac"], site
        for field in ("absmax", "rms", "sat_frac"):
            assert st[field] == pytest.approx(want[field],
                                              abs=LOGITS_ATOL), (site, field)


def test_paged_int8_taps_cover_quant_surfaces(models):
    kw = dict(kv_dtype="int8", weight_dtype="int8")
    eng = _build("port", "paged", models, True, **kw)
    ref = _build("jax", "paged", models, True, **kw)
    for e in (eng, ref):
        e.prefill(0, PROMPT)
        e.decode()
    sites = set(eng.last_numerics)
    assert {"decode.logits", "kv.codes", "kv.scale",
            "weights.q", "weights.scale"} <= sites
    assert sites == set(ref.last_numerics)
    assert eng.numerics_monitor.total() == 0
    assert eng.capture_counts["decode"] == 1
    # the int8 weights' codes and scales are the JAX engine's: held as
    # the stats math is; the pools' codes derive from float K/V
    for site in ("weights.q", "weights.scale"):
        got, want = eng.last_numerics[site], ref.last_numerics[site]
        assert got["finite_frac"] == want["finite_frac"] == 1.0
        assert got["absmax"] == want["absmax"]
        assert got["sat_frac"] == want["sat_frac"]
        assert got["rms"] == pytest.approx(want["rms"], rel=1e-6)
    for site in ("kv.codes", "kv.scale"):
        got, want = eng.last_numerics[site], ref.last_numerics[site]
        assert got["finite_frac"] == want["finite_frac"] == 1.0
        for field in ("absmax", "rms", "sat_frac"):
            assert got[field] == pytest.approx(want[field], rel=1e-3,
                                               abs=1e-4), (site, field)


# ----------------------------------------------------------------- chaos

def _nan_drill(pkg, models):
    eng = _build(pkg, "paged", models, True)
    eng.prefill(0, PROMPT)
    eng.prefill(1, PROMPT[:5])
    faults = jfaults if pkg == "jax" else tfaults
    faults.arm("numerics.corrupt", mode="nan", nth=1, max_fires=1,
               target=POISON)
    try:
        eng.decode()
    finally:
        faults.disarm_all()
    return eng


def test_chaos_nan_detected_localized_bundled_one_step(models):
    assert "numerics.corrupt" in tfaults.SITES
    eng = _nan_drill("port", models)
    ref = _nan_drill("jax", models)
    mon = eng.numerics_monitor
    assert mon.counts().get("decode.logits:nonfinite", 0) >= 1, mon.counts()
    assert mon.counts() == ref.numerics_monitor.counts()
    loc = eng.last_localization
    assert loc is not None
    assert loc["first_unhealthy_layer"] == 1 and loc["site"] == "layer1.act"
    assert loc["stats"]["finite_frac"] < 1.0
    assert loc["layers"] == models[1].cfg.num_layers
    want = ref.last_localization
    assert {k: loc[k] for k in ("first_unhealthy_layer", "site", "probes",
                                "layers")} == \
        {k: want[k] for k in ("first_unhealthy_layer", "site", "probes",
                              "layers")}
    assert mon.bundle_path and os.path.exists(mon.bundle_path)
    with open(mon.bundle_path) as f:
        assert "numerics_localization" in json.dumps(json.load(f))
    # decode captured once; the probes count apart
    assert eng.capture_counts == {"decode": 1, "prefill[32]": 1}
    assert eng.trace_counts["decode"] == 1
    assert eng.trace_counts["numerics_probe"] == loc["probes"] >= 1
    # the prefill masters were never poisoned; the decode storage was
    assert bool(torch.isfinite(eng._params[POISON]).all())
    assert not bool(torch.isfinite(eng._decode_params[POISON]).all())
    # a fresh engine over the same model is healthy
    fresh = _build("port", "paged", models, True)
    fresh.prefill(0, PROMPT)
    fresh.decode()
    assert fresh.numerics_monitor.total() == 0


def test_localizer_probes_leave_the_pool_as_the_step_left_it(models,
                                                            monkeypatch):
    """The pool as the poisoned live step left it, and after the
    localizer's probes replayed that step: equal bit for bit (NaN where
    NaN), every block the garbage block included."""
    seen = []
    real = PagedGenerationEngine.localize_numerics

    def watched(self, sat_frac_max=0.25):
        before = [t.clone() for layer in self._pool for t in layer]
        rec = real(self, sat_frac_max)
        after = [t for layer in self._pool for t in layer]
        seen.append(all(torch.equal(torch.nan_to_num(a, nan=7.0),
                                    torch.nan_to_num(b, nan=7.0))
                        for a, b in zip(before, after)))
        return rec
    monkeypatch.setattr(PagedGenerationEngine, "localize_numerics",
                        watched)
    eng = _nan_drill("port", models)
    assert eng.trace_counts["numerics_probe"] >= 1
    assert seen == [True]


def _scale_zero_drill(pkg, models):
    eng = _build(pkg, "paged", models, True, kv_dtype="int8",
                 weight_dtype="int8")
    eng.prefill(0, PROMPT)
    # the baseline fills with the last healthy step
    for _ in range(eng.numerics_monitor.min_history):
        eng.decode()
    assert eng.numerics_monitor.total() == 0
    faults = jfaults if pkg == "jax" else tfaults
    faults.arm("numerics.corrupt", mode="scale_zero", nth=1, max_fires=1,
               target="blocks.0.mlp.fc1.weight")
    try:
        eng.decode()
    finally:
        faults.disarm_all()
    return eng


def test_chaos_scale_zero_drifts_weight_scales(models):
    eng = _scale_zero_drill("port", models)
    kinds = eng.numerics_monitor.counts()
    assert kinds.get("weights.scale:drift", 0) >= 1, kinds
    assert kinds == _scale_zero_drill("jax", models).numerics_monitor.counts()
    assert eng.capture_counts["decode"] == 1
    assert "numerics_probe" not in eng.trace_counts   # nothing nonfinite


def test_corrupt_spec_parses_target_from_env():
    specs = tfaults.load_env(
        "numerics.corrupt=nan:nth=2:max=1:target=blocks.0.attn.weight")
    try:
        assert len(specs) == 1 and specs[0].mode == "nan"
        assert specs[0].target == "blocks.0.attn.weight"
        assert tfaults.fire("numerics.corrupt") is None     # nth=2
        assert tfaults.fire("numerics.corrupt") is specs[0]
    finally:
        tfaults.disarm_all()


# ------------------------------------------------------ host-tier requant

def _rail_block():
    return {"ns": None, "parent": None, "quant": False,
            "arrays": {"k0": np.ones((8, 2, 4), np.float32)}}


def test_host_tier_feeds_process_monitor():
    from paddle_tpu.serving.kv_tiers import HostTier as JHostTier
    counts = {}
    for name, mod, tier_cls in (("port", tnum, HostTier),
                                ("jax", jnum, JHostTier)):
        mon = mod.NumericsMonitor(sat_frac_max=0.25, auto_bundle=False)
        prev = mod.set_monitor(mon)
        try:
            tier = tier_cls(8, dtype="int8")
            tier.put("a", _rail_block())
            ramp = np.linspace(0.01, 1.0, 64, dtype=np.float32)
            tier.put("b", {"ns": None, "parent": None, "quant": False,
                           "arrays": {"k0": ramp.reshape(8, 2, 4)}})
        finally:
            mod.set_monitor(prev)
        counts[name] = (mon.counts(), mon.site_stats(),
                        tier.saturation_stats())
    assert counts["port"] == counts["jax"]
    assert counts["port"][0].get("kv_tier.requant_codes:saturation") == 1
    # without a monitor the observation point is a no-op
    assert tnum.get_monitor() is None
    HostTier(8, dtype="int8").put("a", _rail_block())


def test_ledger_demote_carries_sat_and_serve_report_joins():
    led = tkvl.KVLedger(num_blocks=4)
    led.tier_demote((1,), "key1", "host", "default", sat=0.5)
    led.tier_demote((2,), "key2", "host", "default", sat=0.3)
    led.tier_demote((), "key3", "disk", "default")
    evs = [e for e in led.events if e["event"] == "tier_demote"]
    assert evs[0]["sat"] == pytest.approx(0.5) and "sat" not in evs[2]
    recs = [dict(e, kind="kvledger") for e in evs]
    assert serve_report.validate_records(recs) == []
    host = serve_report.kv_residency(recs)["tiers"]["host"]
    assert host["requant_sat"]["samples"] == 2
    assert host["requant_sat"]["mean"] == pytest.approx(0.4)


def test_metrics_compare_gates_anomalies(tmp_path):
    """The port's anomaly counter in a registry snapshot: `--compare`
    from a clean baseline names it and exits 1."""
    def snap(n):
        return {"schema": "paddle_tpu.metrics.v1", "ts": 1.0, "pid": 1,
                "metrics": [{
                    "name": "numerics_anomaly_total", "type": "counter",
                    "help": "", "labelnames": ["site", "kind"],
                    "samples": [{"labels": {"site": "decode.logits",
                                            "kind": "nonfinite"},
                                 "value": n}]}]}
    pa, pb = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    for path, rec in ((pa, snap(0)), (pb, snap(1))):
        with open(path, "w") as f:
            f.write(json.dumps(rec) + "\n")
    cli = [sys.executable, os.path.join(ROOT, "tools", "metrics_report.py")]
    bad = subprocess.run(cli + ["--compare", pa, pb], capture_output=True,
                         text=True, timeout=60)
    assert bad.returncode == 1, bad.stdout + bad.stderr
    assert "numerics_anomaly_total" in bad.stdout
