"""The port's pipeline-parallel paged engine against the JAX package's, on
the CPU.

The JAX tiny GPT (hidden 128, 2 layers, 4 heads, vocab 1024) is built from
a fixed seed and its weights carried into the port with `load_jax_params`.
The JAX `PipelineParallelPagedEngine` runs on the 8 virtual CPU devices
`tests/conftest.py` sets up (its default gather attention, as its own
tests run it); the port's runs `device="cpu"` with every stage and shard
on the CPU. Then:

  * the tick tables of `parallel/pipeline_schedule.py` equal the JAX
    module's (training tables, interleaved tables, arrivals, slots, the
    serving tables and their stats);
  * greedy streams are token-exact against the JAX pp engine and the
    port's single-device engine: (tp=2, pp=2), chunked prefill through
    the stages, int8 KV and weights, adapters (each stage gathering its
    own layers' rows), a single-device bundle adopted and a hot swap
    mid-stream, the pp engine's bundle adopted back;
  * each stage executable is captured once (a recording stand-in for the
    CUDA graphs) and the capture counts equal the JAX per-stage trace
    counts; `stage_report` names each stage's layers, device and heads;
  * `serving.pp_handoff` fires on every hop, and a raise mid-ring is
    contained by the scheduler's quarantine;
  * the bubble gauges equal (pp-1)/(M+pp-1) over a decode window, and the
    scheduler's step records render through `tools/serve_report.py`;
  * sampled streams replay on another slot and resume mid-stream;
  * the KV ledger on or off and the numerics taps armed or not leave the
    streams and the capture counts alone (tp and pp);
  * per-shard bytes under half the single device's, pp at twice the
    blocks no dearer a device than tp alone, and the pp decode rate
    within the reference's stated bound of the tp engine's;
  * the Predictor serves a pp record (no warning, no dense engine), and
    `worker_main --engine pp` serves over the fabric.
"""
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.parallel import pipeline_schedule as jsched
from paddle_tpu.serving import tenancy as jten
from paddle_tpu.serving.distributed import (
    PipelineParallelEngineConfig as JPPConfig,
    PipelineParallelPagedEngine as JPPEngine)
from paddle_tpu.text.models import gpt_tiny as jgpt_tiny
from paddle_tpu.text.models.gpt import gpt_stage_ranges as jranges
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.observability import faults as tfaults
from paddle_tpu_torch.observability import kvledger as tkvl
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.parallel import pipeline_schedule as tsched
from paddle_tpu_torch.serving import (PagedGenerationEngine, Scheduler,
                                      ServingConfig, graphs,
                                      save_for_generation)
from paddle_tpu_torch.serving import tenancy as tten
from paddle_tpu_torch.serving.distributed import (
    DistFrontend, PipelineParallelEngineConfig, PipelineParallelPagedEngine,
    TensorParallelEngineConfig, TensorParallelPagedEngine,
    free_eager_device_copies)
from paddle_tpu_torch.text.models import (GPTStage, gpt_pipeline_stages,
                                          gpt_stage_ranges, gpt_tiny)
from paddle_tpu_torch.text.models.convert import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import serve_report  # noqa: E402

ENGINE_KW = dict(slots=4, max_len=64, block_size=8)
STEPS = 8


@pytest.fixture(scope="module")
def models():
    """(JAX tiny GPT, the port's tiny GPT on the CPU with its weights)."""
    paddle_tpu.seed(7)
    jm = jgpt_tiny()
    jm.eval()
    params = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, load_jax_params(gpt_tiny(device="cpu"), params)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the tiny engines' products
    gain nothing from more, and test workers share the host's cores (the
    thread count is put back after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults():
    tfaults.disarm_all()
    yield
    tfaults.disarm_all()


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 1000, n).tolist()


PROMPTS = [_prompt(110 + s, 7 + s) for s in range(4)]


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


def _recording(eng):
    eng._exe = _RecordingExecutables(eng.device)
    return eng


def _port_pp(tm, **kw):
    return _recording(PipelineParallelPagedEngine(
        tm, PipelineParallelEngineConfig(**dict(ENGINE_KW, pp=2, **kw)),
        device="cpu"))


def _one(tm, **kw):
    return PagedGenerationEngine(tm, device="cpu", **dict(ENGINE_KW, **kw))


def _stream(engine, prompts=PROMPTS, steps=STEPS, adapters=None):
    rows = [[engine.prefill(s, p)] for s, p in enumerate(prompts)]
    for s, idx in (adapters or {}).items():
        engine.set_slot_adapter(s, idx)
    for _ in range(steps):
        engine.ensure_decode_capacity()
        out = engine.decode()
        for s in range(len(prompts)):
            rows[s].append(int(out[s]))
    return rows


def _jax_captures(trace_counts):
    """The JAX pp engine's per-stage trace counts as the port's executable
    names."""
    out = {f"decode_stage[{s}]": n
           for s, n in trace_counts.get("decode_pp", {}).items()}
    for key, n in trace_counts.get("prefill_pp", {}).items():
        out[f"prefill_head[{key[1]}]" if key[0] == "head"
            else f"prefill_stage[{key[0]}][{key[1]}]"] = n
    for s, n in trace_counts.get("verify_pp", {}).items():
        out[f"verify_stage[{s}]"] = n
    return out


def _gauge(name):
    flat = tmetrics.flatten_snapshot(tmetrics.registry().snapshot(),
                                     kinds=("gauge",))
    return flat.get(name)


# ------------------------------------------------------- schedule tables

@pytest.mark.parametrize("case", [
    ("build_tables", (8, 4, "1f1b")), ("build_tables", (8, 4, "gpipe")),
    ("build_tables", (8, 4, "eager1f1b")),
    ("build_interleaved_tables", (8, 4, 2)),
    ("build_serving_tables", (4, 3)),
    ("build_serving_tables", (4, 3, 4))], ids=lambda c: f"{c[0]}{c[1]}")
def test_schedule_tables_match_jax(case):
    """The port's copy of the tick-table module gives the JAX module's
    tables, arrivals, slot counts and stats."""
    fn, args = case
    got, want = getattr(tsched, fn)(*args), getattr(jsched, fn)(*args)
    if fn == "build_serving_tables":
        np.testing.assert_array_equal(got, want)
        assert tsched.serving_schedule_stats(got) == \
            jsched.serving_schedule_stats(want)
        return
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    fwd, bwd = got[0], got[1]
    if fwd.ndim == 2:
        assert tsched.schedule_stats(fwd, bwd) == \
            jsched.schedule_stats(fwd, bwd)
        fwd, bwd = fwd[:, :, None], bwd[:, :, None]
    pp, vpp = fwd.shape[1], fwd.shape[2]
    arr = tsched.arrival_tables(fwd, bwd, pp, vpp)
    for a, b in zip(arr, jsched.arrival_tables(fwd, bwd, pp, vpp)):
        np.testing.assert_array_equal(a, b)
    assert tsched.required_slots(fwd, bwd, *arr, args[0], pp, vpp) == \
        jsched.required_slots(fwd, bwd, *arr, args[0], pp, vpp)


def test_serving_schedule_tables():
    """Microbatch g runs stage s at tick g+s; every stage works every tick
    after the fill; the bubble fraction is (pp-1)/(M+pp-1)."""
    tbl = tsched.build_serving_tables(4, 3)
    assert tbl.shape == (6, 3)
    for t in range(6):
        for s in range(3):
            g = t - s
            assert tbl[t, s] == (g if 0 <= g < 4 else -1)
    stats = tsched.serving_schedule_stats(tbl)
    assert stats["ticks"] == 6 and stats["stage_busy"] == [4 / 6] * 3
    assert abs(stats["bubble_frac"] - 2 / 6) < 1e-9


def test_stage_split_and_stages_compose(models):
    """`gpt_stage_ranges` splits as the JAX helper does, and the stages,
    chained, are the model's cached forward bit for bit."""
    _, tm = models
    for layers, pp, explicit in ((12, 2, None), (12, 5, None), (7, 3, None),
                                 (6, 2, (1, 5))):
        assert gpt_stage_ranges(layers, pp, explicit) == \
            jranges(layers, pp, explicit)
    with pytest.raises(ValueError, match="stage_layers"):
        gpt_stage_ranges(4, 2, (1, 1))
    stages = gpt_pipeline_stages(tm, 2)
    assert [(s.start, s.stop, s.is_first, s.is_last) for s in stages] == \
        [(0, 1, True, False), (1, 2, False, True)]
    assert stages[1].head_wte is tm.wte        # the tied head, shared
    ids = torch.tensor([PROMPTS[0]])
    whole = tm.gen_cache(1, 32)
    want, _ = tm(ids, cache=whole)
    cache = tm.gen_cache(1, 32)
    x = ids
    for st in stages:
        part = cache._replace(layers=cache.layers[st.start:st.stop])
        x, _ = st(x, cache=part, pos=cache.pos,
                  op="block_head" if st.is_last else "block")
    assert torch.equal(x, want)
    assert isinstance(stages[0], GPTStage)


# -------------------------------------------------- the (tp, pp) engine

def test_pp_tp_serves_token_exact_and_captures_once(models):
    """(tp=2, pp=2): streams equal the JAX pp engine's and the port's
    single-device engine's; each stage executable is captured once, as
    the JAX engine traces it, and the base decode never; each stage holds
    its layers with heads/tp per shard; a shard holds under half the
    single device's bytes; the bubble gauge reads (pp-1)/(M+pp-1) over a
    decode window."""
    jm, tm = models
    jpp = JPPEngine(jm, JPPConfig(pp=2, tp=2, **ENGINE_KW))
    want = _stream(jpp)
    pp = _port_pp(tm, tp=2)
    assert _stream(pp) == want
    assert _stream(_one(tm)) == want
    assert pp.capture_counts == _jax_captures(jpp.trace_counts)
    assert pp.capture_counts == {
        "decode_stage[0]": 1, "decode_stage[1]": 1,
        "prefill_stage[0][32]": 1, "prefill_stage[1][32]": 1,
        "prefill_head[32]": 1}
    assert [r["layers"] for r in pp.stage_report()] == [[0, 1], [1, 2]]
    for r in pp.stage_report():
        assert r["device"] == "cpu"
        assert set(r["heads_per_shard"].values()) == {2}
    acc, one = pp.hbm_accounting(), _one(tm).hbm_accounting()
    assert len(acc["per_shard"]) == 4
    assert acc["max_shard_total"] < one["max_device_total"] / 2
    for rec in acc["per_shard"].values():
        assert rec["kv"] == one["kv_total"] // 4
    M = pp.config.decode_microbatches
    assert M == 2
    pp.reset_pp_stats()
    for _ in range(3):
        pp.decode()
    stats = pp.pp_stats()
    assert stats["bubble_fraction"] == pytest.approx(1 / (M + 1))
    assert _gauge("serving_pp_bubble_fraction") == \
        pytest.approx(stats["bubble_fraction"])
    assert _gauge("serving_pp_stage_busy{stage=0}") == \
        pytest.approx(stats["stage_busy"][0])


def test_pp_chunked_prefill_token_exact(models):
    """8-token chunks stream through the stages (3 chunks of a 19-token
    prompt): the stream equals the JAX chunked engine's and the single
    device's, and the prefill executables collapse to one a stage plus
    the head."""
    jm, tm = models
    prompt = [_prompt(120, 19)]
    jpp = JPPEngine(jm, JPPConfig(pp=2, prefill_chunk=8, **ENGINE_KW))
    want = _stream(jpp, prompt, 6)
    pp = _port_pp(tm, prefill_chunk=8)
    assert _stream(pp, prompt, 6) == want == _stream(_one(tm), prompt, 6)
    assert pp.capture_counts == _jax_captures(jpp.trace_counts)
    assert {n for n in pp.capture_counts if n.startswith("prefill")} == \
        {"prefill_stage[0][8]", "prefill_stage[1][8]", "prefill_head[8]"}


def test_pp_handoff_fires_every_hop_and_fault_contained(models):
    """`serving.pp_handoff` fires once a hop (M*(pp-1) a decode step);
    armed to raise mid-ring, the in-flight request fails loudly, the
    scheduler keeps stepping, and the next request's stream equals the
    single-device scheduler's."""
    _, tm = models
    pp = _port_pp(tm, prefill_chunk=8)
    for s, p in enumerate(PROMPTS):
        pp.prefill(s, p)
    spec = tfaults.arm("serving.pp_handoff", mode="delay", delay_s=0.0)
    pp.decode()
    tfaults.disarm_all()
    assert spec.fires == pp.config.decode_microbatches * (pp.config.pp - 1)
    for s in range(4):
        pp.reset_slot(s)

    prompt = _prompt(121, 9)
    oracle = Scheduler(_one(tm), ServingConfig(default_max_new_tokens=5),
                       device="cpu")
    ho = oracle.submit(prompt)
    while oracle.step():
        pass
    sched = Scheduler(pp, ServingConfig(default_max_new_tokens=5),
                      device="cpu")
    h = sched.submit(prompt)
    sched.step()
    tfaults.arm("serving.pp_handoff", mode="raise", max_fires=1)
    while sched.step():
        pass
    assert h.status == "ERROR" and "fault-injection" in (h.error or "")
    h2 = sched.submit(prompt)
    while sched.step():
        pass
    assert h2.status == "DONE" and h2.tokens == ho.tokens


SAMPLING = dict(decode_strategy="sampling", temperature=0.9, top_k=32)


def test_pp_per_slot_rng_replay_and_resume(models):
    """Sampled pp streams are the single-device engine's for the same
    (seed, generation index): replayed on another slot beside a noise
    occupant, and resumed mid-stream at gen=3."""
    _, tm = models
    p = _prompt(140, 9)
    one = _one(tm, **SAMPLING)
    want = [one.prefill(0, p, rng=(31337, 0))]
    for _ in range(6):
        one.ensure_decode_capacity()
        want.append(int(one.decode()[0]))
    e2 = _port_pp(tm, **SAMPLING)
    e2.prefill(0, _prompt(141, 5))
    got = [e2.prefill(2, p, rng=(31337, 0))]
    for _ in range(6):
        e2.ensure_decode_capacity()
        got.append(int(e2.decode()[2]))
    assert got == want
    e3 = _port_pp(tm, **SAMPLING)
    resumed = [e3.prefill(1, p + want[:3], rng=(31337, 3))]
    for _ in range(3):
        e3.ensure_decode_capacity()
        resumed.append(int(e3.decode()[1]))
    assert resumed == want[3:]


def test_serve_report_renders_pp_stage_column(models, tmp_path):
    """The scheduler's run record carries the (tp, pp) shape and its step
    records the pp fields; `tools/serve_report.py` validates them and
    renders the per-stage busy column and the bubble line."""
    _, tm = models
    path = str(tmp_path / "serve.jsonl")
    sched = Scheduler(_port_pp(tm), ServingConfig(
        default_max_new_tokens=4, metrics_path=path), device="cpu")
    hs = [sched.submit(p) for p in PROMPTS[:2]]
    while sched.step():
        pass
    assert all(h.status == "DONE" for h in hs)
    records = serve_report.load(path)
    assert serve_report.validate_records(records) == []
    run = next(r for r in records if r["kind"] == "run")
    assert (run["engine"], run["tp"], run["pp"]) == ("pp", 1, 2)
    step = [r for r in records if r["kind"] == "step"][-1]
    assert 0.0 < step["pp_bubble_fraction"] < 1.0
    assert len(step["pp_stage_busy"]) == 2
    out = serve_report.render(serve_report.summarize(records))
    assert "tp=1 pp=2" in out
    assert "bubble fraction" in out


def test_pp_compose_handoff_swap_int8(models):
    """A single-device bundle adopts onto the stages, a hot swap of the
    same weights mid-stream re-slices every stage in place, the pp
    bundle adopts back onto one device, and int8 KV and weights on the
    stages equal the JAX int8 pp engine and the single-device int8
    engine."""
    jm, tm = models
    prompt = _prompt(150, 10)
    want = _stream(_one(tm), [prompt], 7)[0]
    a = _one(tm)
    first = a.prefill(0, prompt)
    ks, vs, plen = a.extract_kv(0)
    pp = _port_pp(tm, tp=2)
    pp.adopt_kv(0, ks, vs, plen, first)
    got = [first]
    for _ in range(2):
        got.append(int(pp.decode()[0]))
    pp.swap_params({k: v.detach().clone()
                    for k, v in tm.state_dict().items()})
    for _ in range(2):
        got.append(int(pp.decode()[0]))
    assert got == want[:5]
    assert pp.capture_counts == {"decode_stage[0]": 1,
                                 "decode_stage[1]": 1}
    ks2, vs2, plen2 = pp.extract_kv(0)
    b = _one(tm)
    b.adopt_kv(0, ks2, vs2, plen2, got[-1])
    assert [int(b.decode()[0]) for _ in range(3)] == want[5:8]
    q = dict(kv_dtype="int8", weight_dtype="int8")
    jq = JPPEngine(jm, JPPConfig(pp=2, tp=2, **ENGINE_KW, **q))
    wantq = _stream(jq, steps=5)
    assert _stream(_port_pp(tm, tp=2, **q), steps=5) == wantq
    assert _stream(_one(tm, **q), steps=5) == wantq


def test_pp_adapter_stream_matches_single_device(models):
    """Decode under adapters on the ring: each stage gathers its own
    layers' rows, and the stream equals the single-device adapter stream
    and the JAX pp engine's, token for token."""
    jm, tm = models
    prompts = PROMPTS[:2]

    def bank(mod, cfg):
        b = mod.AdapterBank(cfg, n_adapters=3, rank=4)
        b.load("acme", jten.init_adapter_state(cfg, 4, seed=1, scale=1.0))
        return b
    jpp = JPPEngine(jm, JPPConfig(pp=2, **ENGINE_KW))
    jpp.attach_adapters(bank(jten, jm.cfg))
    want = _stream(jpp, prompts, 6, {1: jpp.adapter_bank.slot_of("acme")})
    for eng in (_port_pp(tm), _port_pp(tm, tp=2), _one(tm)):
        eng.attach_adapters(bank(tten, tm.cfg))
        got = _stream(eng, prompts, 6,
                      {1: eng.adapter_bank.slot_of("acme")})
        assert got == want
    plain = _stream(_one(tm), prompts, 6)
    assert plain[1] != want[1]            # the adapter changed the stream


@pytest.mark.parametrize("kind", ["tp", "pp"])
def test_ledger_disabled_streams_bit_identical(models, kind):
    """The KV ledger on or off: the same streams and the same capture
    counts, and a ledger with events when on."""
    _, tm = models
    streams, captures, ledgers = [], [], []
    for on in (True, False):
        (tkvl.enable if on else tkvl.disable)()
        try:
            eng = _recording(
                TensorParallelPagedEngine(tm, TensorParallelEngineConfig(
                    tp=2, slots=2, max_len=32, block_size=4, num_blocks=12,
                    enable_prefix_cache=False), device="cpu")
                if kind == "tp" else
                PipelineParallelPagedEngine(
                    tm, PipelineParallelEngineConfig(
                        pp=2, tp=2, slots=2, max_len=32, block_size=4,
                        num_blocks=12, enable_prefix_cache=False),
                    device="cpu"))
        finally:
            tkvl.enable()
        sched = Scheduler(eng, max_queue=8, device="cpu")
        hs = [sched.submit(p[:5], max_new_tokens=4) for p in PROMPTS[:2]]
        sched.run_until_idle()
        assert all(h.status == "DONE" for h in hs)
        streams.append([h.tokens for h in hs])
        captures.append(dict(eng.capture_counts))
        ledgers.append(eng.kv_ledger)
    assert streams[0] == streams[1]
    assert captures[0] == captures[1]
    assert ledgers[1] is None and len(ledgers[0].events) > 0


@pytest.mark.parametrize("kind", ["tp", "pp"])
def test_taps_disabled_bit_identical_enabled_captures_once(models, kind):
    """Numerics taps disarmed or armed: the same tokens and capture counts,
    and the armed engine's sinks healthy (pp taps each stage's hop
    activation and the logits)."""
    _, tm = models
    toks, caps, engs = [], [], []
    for armed in (False, True):
        kw = dict(ENGINE_KW, numerics_taps=armed, tp=2)
        eng = _recording(
            TensorParallelPagedEngine(tm, TensorParallelEngineConfig(**kw),
                                      device="cpu") if kind == "tp" else
            PipelineParallelPagedEngine(
                tm, PipelineParallelEngineConfig(pp=2, **kw), device="cpu"))
        toks.append(_stream(eng, PROMPTS[:2], 3))
        caps.append(dict(eng.capture_counts))
        engs.append(eng)
    assert toks[0] == toks[1] and caps[0] == caps[1]
    off, on = engs
    assert off.numerics_monitor is None
    sites, ingest = set(), on._ingest_numerics

    def spy(sink):
        sites.update(sink)
        ingest(sink)
    on._ingest_numerics = spy
    on.decode()
    assert on.numerics_monitor.total() == 0
    assert "decode.logits" in sites
    assert ("stage0.act" in sites) == (kind == "pp")
    for site, st in on.last_numerics.items():
        assert st["finite_frac"] == 1.0, (site, st)


def test_pp_equal_hbm_and_rate_bound_vs_tp_only(models):
    """At twice the blocks pp=2 (tp=2) holds no more a shard than the tp
    engine (tp=2) a shard, and its decode rate on the CPU stays within
    the reference's stated bound (0.25x) of the tp engine's."""
    _, tm = models
    tp = _recording(TensorParallelPagedEngine(
        tm, TensorParallelEngineConfig(tp=2, **ENGINE_KW), device="cpu"))
    nb = tp.config.num_blocks
    pp = _port_pp(tm, tp=2, num_blocks=2 * (nb - 1) + 1)
    assert pp.hbm_accounting()["max_shard_total"] <= \
        1.05 * tp.hbm_accounting()["max_shard_total"]
    for e in (tp, pp):
        for s, p in enumerate(PROMPTS):
            e.prefill(s, p)
        e.decode()

    def rate(engine, steps=8):
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.ensure_decode_capacity()
            engine.decode()
        return steps * engine.config.slots / (time.perf_counter() - t0)
    # the best of three interleaved trials each: a loaded host's stalls
    # land on either engine
    rates = [(rate(tp), rate(pp)) for _ in range(3)]
    r_tp, r_pp = (max(r[i] for r in rates) for i in range(2))
    assert r_pp >= 0.25 * r_tp, (r_pp, r_tp)


def test_predictor_serves_a_pp_record(models, tmp_path):
    """A `.gencfg` record of kind "pp" builds the pipeline engine in the
    Predictor, with no warning and no dense engine, and serves the
    single-device stream; the model's device tensors can go back to the
    host once the engine holds its own."""
    _, tm = models
    prefix = str(tmp_path / "pp")
    cfg = PipelineParallelEngineConfig(pp=2, **ENGINE_KW)
    save_for_generation(tm, prefix, engine_config=cfg)
    meta = json.load(open(prefix + ".gencfg"))
    assert meta["serving"]["engine"] == "pp"
    assert meta["serving"]["executables"] == \
        PipelineParallelPagedEngine(tm, cfg, device="cpu").executable_names()
    pc = Config(prefix)
    pc.disable_gpu()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pred = create_predictor(pc)
    assert type(pred.engine) is PipelineParallelPagedEngine
    got = pred.generate([PROMPTS[0]], max_new_tokens=5)
    assert got[0] == _stream(_one(tm), [PROMPTS[0]], 4)[0]
    assert free_eager_device_copies(tm) == (0, 0)     # already on the host


def test_worker_main_serves_pp(tmp_path):
    """`worker_main --engine pp`: the process publishes its endpoint,
    serves a request token-exact against the same seed in this process,
    reports its (tp, pp) shape, each shard's device and the ring's stats
    in STAT, and exits 0 on STOP."""
    ep_file = str(tmp_path / "pp0.ep")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PTN_FAULTS", "PTN_TRACE_EXPORT_DIR")}
    env.update(PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    kw = dict(ENGINE_KW, pp=2, tp=2)
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "paddle_tpu_torch.serving.distributed.worker_main",
         "--device", "cpu", "--model", "gpt_tiny", "--seed", "3",
         "--engine", "pp", "--engine-config", json.dumps(kw),
         "--serving-config", json.dumps({"default_max_new_tokens": 4}),
         "--endpoint-file", ep_file],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    fe = None
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(ep_file):
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            assert time.monotonic() < deadline, "no endpoint published"
            time.sleep(0.05)
        fe = DistFrontend([open(ep_file).read().strip()])
        prompt = _prompt(5, 6)
        r = fe.submit(prompt, max_new=4)
        fe.run(timeout_s=60)
        assert r.status == "DONE"
        sched = Scheduler(_one(gpt_tiny(device="cpu", seed=3)),
                          ServingConfig(default_max_new_tokens=4),
                          device="cpu")
        h = sched.submit(prompt)
        while sched.step():
            pass
        assert r.tokens == h.tokens
        stat = fe.decode.stat(0)
        assert stat["parallel"]["pp"] == 2 and stat["parallel"]["tp"] == 2
        assert stat["parallel"]["devices"] == {
            f"stage{s}.tp{t}": "cpu" for s in range(2) for t in range(2)}
        assert 0.0 < stat["pp_stats"]["bubble_fraction"] < 1.0
        fe.stop_workers()
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err[-3000:]
        line = [ln for ln in err.splitlines()
                if ln.startswith("worker_main exit: ")][-1]
        assert json.loads(line[len("worker_main exit: "):])["engine"] == "pp"
    finally:
        if fe is not None:
            fe.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_sharded_tiers_and_prefix_restore(models, kv_dtype):
    """The shards' pools through the whole-model view: a (tp=2, pp=2)
    engine with KV tiers evicts a served prompt's blocks to the host tier
    and promotes them back on resubmission with the single-device tiered
    engine's stream, and a chain exported by a single-device engine
    (`extract_prefix_kv`) restores into it and serves a prefix hit."""
    _, tm = models
    prompt = _prompt(40, 26)                 # 3 full blocks + a tail

    def serve(eng):
        sched = Scheduler(eng, max_queue=4, device="cpu")
        h = sched.submit(prompt, max_new_tokens=6)
        sched.run_until_idle()
        return h.tokens
    kw = dict(kv_dtype=kv_dtype, enable_kv_tiers=True, host_tier_blocks=8)
    one = _one(tm, **kw)
    want = serve(one)
    pp = _port_pp(tm, tp=2, **kw)
    assert serve(pp) == want
    assert pp.prefix_cache.evict(999) == 3
    assert sorted(pp.kv_tiers.residency().values()) == ["host"] * 3
    assert serve(pp) == want
    assert pp.trace_counts["tier_restore"] == 1
    assert pp.last_prefill_stats["tier_promoted_blocks"] == 3
    ks, vs, n = one.extract_prefix_kv(prompt)
    fresh = _port_pp(tm, tp=2, kv_dtype=kv_dtype)
    assert fresh.restore_prefix(prompt, ks, vs, n) == n == 24
    assert serve(fresh) == want
    assert fresh.last_prefill_stats["prefix_hit_tokens"] == 24


def test_pp_nan_drill_localizes_layer_one(models, tmp_path):
    """`numerics.corrupt` plants a NaN in layer 1's ln1 weight of an armed
    (tp=2, pp=2) engine: the decode step latches `decode.logits`
    nonfinite, the localizer's eager probes through the stages name layer
    1, the probes leave the pool as the step left it, and the host
    masters stay finite."""
    from paddle_tpu_torch.observability import flight_recorder as tfr
    _, tm = models
    rec = tfr.get()
    prev, rec.dir = rec.dir, str(tmp_path / "pm")
    try:
        eng = _port_pp(tm, tp=2, numerics_taps=True)
        eng.prefill(0, PROMPTS[0])
        eng.prefill(1, PROMPTS[1])
        real = eng.localize_numerics
        seen = []

        def watched(sat_frac_max=0.25):
            before = [t.clone() for sh in eng._shards for layer in sh.pool
                      for t in layer]
            out = real(sat_frac_max)
            seen.append(all(
                torch.equal(torch.nan_to_num(a, nan=7.0),
                            torch.nan_to_num(b, nan=7.0))
                for a, b in zip(before, [t for sh in eng._shards
                                         for layer in sh.pool
                                         for t in layer])))
            return out
        eng.localize_numerics = watched
        tfaults.arm("numerics.corrupt", mode="nan", nth=1, max_fires=1,
                    target="blocks.1.ln1.weight")
        eng.decode()
    finally:
        tfaults.disarm_all()
        rec.dir = prev
    counts = eng.numerics_monitor.counts()
    assert counts.get("decode.logits:nonfinite", 0) >= 1, counts
    loc = eng.last_localization
    assert loc["first_unhealthy_layer"] == 1 and loc["site"] == "layer1.act"
    assert seen == [True]
    assert eng.trace_counts["numerics_probe"] == loc["probes"] >= 1
    assert bool(torch.isfinite(eng._params["blocks.1.ln1.weight"]).all())
    assert eng.capture_counts["decode_stage[1]"] == 1
