"""The port's speculative decode on the pipeline ring against the JAX
package's, on the CPU.

The JAX tiny GPT (hidden 128, 2 layers, 4 heads, vocab 1024) is built from
a fixed seed and its weights carried into the port with `load_jax_params`;
the JAX engines run on the 8 virtual CPU devices of `tests/conftest.py`,
the port's on the CPU (`device="cpu"`, the kernel wrappers' plain
versions). The spec x pp streams are held to the one-token pp engine's
(the JAX test that also holds them to the single-device speculative
engine's trace counts fails in the JAX package, ROADMAP C.3), and to the
JAX spec x pp engine's:

  * `build_serving_tables(..., tokens_per_tick=W)` equals the JAX table
    and keeps the one-token table's skeleton;
  * the config validates and round-trips as the JAX one does, and
    `_engine_kind` names it "spec_pp";
  * (tp=2, pp=2) streams equal the port's one-token pp engine's and the
    JAX spec x pp engine's; the draft and every stage's verify are
    captured once, the one-token paths never; the draft's weights and
    caches are stage-0 bytes in `hbm_accounting`;
  * the masters live on the host, serving replays deterministically, a
    swap from the model's state_dict keeps the stream;
  * the scheduler's run record names the engine and gamma, the spec
    counters carry `engine=spec_pp`;
  * through the scheduler: preemption under an oversubscribed pool and
    an eos inside an accepted window match the one-token reference;
  * int8 KV and weights match the JAX int8 spec x pp engine; a swap and a
    mid-stream handoff to one device continue exactly, the sampler's
    generation index counting every emitted token;
  * `make_engine` and the `.gencfg` record name the per-stage set.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.parallel import pipeline_schedule as jsched
from paddle_tpu.serving.distributed import (
    PipelineParallelSpecConfig as JSpecPPConfig,
    PipelineParallelSpeculativeEngine as JSpecPPEngine)
from paddle_tpu.text.models import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.parallel import pipeline_schedule as tsched
from paddle_tpu_torch.serving import (PagedGenerationEngine, Scheduler,
                                      ServingConfig, graphs, make_engine,
                                      save_for_generation)
from paddle_tpu_torch.serving.distributed import (
    PipelineParallelEngineConfig, PipelineParallelPagedEngine,
    PipelineParallelSpecConfig, PipelineParallelSpeculativeEngine)
from paddle_tpu_torch.serving.engine import _engine_kind, _executable_set
from paddle_tpu_torch.text.models import GPTForGeneration, gpt_tiny
from paddle_tpu_torch.text.models.convert import load_jax_params

ENGINE_KW = dict(slots=2, max_len=64, block_size=8)


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


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 1000, n).tolist()


PROMPTS = [_prompt(210, 7), _prompt(211, 13)]


class _RecordingExecutables(graphs.Executables):
    """The CUDA-graph bookkeeping on the CPU: the first run of a name
    counts as its capture; every run is eager."""

    def run(self, name, fn, inputs, safe=None, upload=True, device=None):
        if name not in self._graphs:
            self.capture_counts[name] = self.capture_counts.get(name, 0) + 1
            self._graphs[name] = True
        inputs.upload()
        return fn(), 0


def _spec_pp(tm, **kw):
    eng = PipelineParallelSpeculativeEngine(
        tm, PipelineParallelSpecConfig(**dict(
            dict(ENGINE_KW, pp=2, gamma=3, draft_layers=1), **kw)),
        device="cpu")
    eng._exe = _RecordingExecutables(eng.device)
    return eng


def _spec_stream(engine, prompts, n_tokens):
    rows = [[engine.prefill(s, p)] for s, p in enumerate(prompts)]
    while min(len(r) for r in rows) < n_tokens:
        toks, n_emit = engine.decode_many()
        for s in range(len(prompts)):
            rows[s].extend(int(t) for t in toks[s, :int(n_emit[s])])
    return [r[:n_tokens] for r in rows]


def _one_token(engine, prompts, n_tokens):
    rows = [[engine.prefill(s, p)] for s, p in enumerate(prompts)]
    for _ in range(n_tokens - 1):
        engine.ensure_decode_capacity()
        out = engine.decode()
        for s in range(len(prompts)):
            rows[s].append(int(out[s]))
    return rows


def _reference(tm, prompt, max_new, eos=None):
    out, lengths = GPTForGeneration(tm).generate(
        torch.tensor([prompt]), max_new_tokens=max_new, eos_token_id=eos)
    return out[0, :int(lengths[0])].tolist()


def test_serving_tables_tokens_per_tick():
    """The tokens-per-tick table equals the JAX one; every busy cell holds
    its microbatch's W token slots on the one-token skeleton, so the
    schedule's bubble is unchanged and a pass moves M*W tokens."""
    tbl2 = tsched.build_serving_tables(4, 3)
    tbl3 = tsched.build_serving_tables(4, 3, tokens_per_tick=4)
    np.testing.assert_array_equal(
        tbl3, jsched.build_serving_tables(4, 3, tokens_per_tick=4))
    for t in range(6):
        for s in range(3):
            g = t - s
            if 0 <= g < 4:
                assert list(tbl3[t, s]) == [g * 4 + w for w in range(4)]
                assert tbl2[t, s] == g
            else:
                assert (tbl3[t, s] == -1).all()
    s2 = tsched.serving_schedule_stats(tbl2)
    s3 = tsched.serving_schedule_stats(tbl3)
    assert s3["bubble_frac"] == pytest.approx(s2["bubble_frac"])
    assert s3["tokens_per_tick"] == 4
    assert s3["ticks_per_token_max"] == pytest.approx(6 / 16)
    with pytest.raises(ValueError, match="tokens_per_tick"):
        tsched.build_serving_tables(2, 2, tokens_per_tick=0)


def test_spec_pp_config_validation():
    cfg = PipelineParallelSpecConfig(pp=2, tp=2, gamma=3, **ENGINE_KW)
    assert _engine_kind(cfg) == "spec_pp"
    cfg2 = PipelineParallelSpecConfig(**cfg.as_dict())
    assert (cfg2.gamma, cfg2.pp, cfg2.tp) == (3, 2, 2)
    jcfg = JSpecPPConfig(pp=2, tp=2, gamma=3, attention_impl="kernel",
                         **ENGINE_KW)
    assert cfg.as_dict() == jcfg.as_dict()
    with pytest.raises(ValueError, match="greedy"):
        PipelineParallelSpecConfig(pp=2, decode_strategy="sampling")
    with pytest.raises(ValueError, match="gamma"):
        PipelineParallelSpecConfig(pp=2, gamma=0)
    with pytest.raises(ValueError, match="pp must be >= 2"):
        PipelineParallelSpecConfig(pp=1)


def test_spec_pp_streams_equal_one_token_pp_and_jax(models):
    """(tp=2, pp=2): the spec x pp streams equal the one-token pp engine's
    and the JAX spec x pp engine's, token for token; one capture of the
    draft and of each stage's verify, none of the one-token paths; the
    draft's weights and caches are counted on stage 0's device."""
    jm, tm = models
    n = 11
    pp = PipelineParallelPagedEngine(
        tm, PipelineParallelEngineConfig(pp=2, tp=2, **ENGINE_KW),
        device="cpu")
    want = _one_token(pp, PROMPTS, n)
    jsp = JSpecPPEngine(jm, JSpecPPConfig(pp=2, tp=2, gamma=3,
                                          draft_layers=1, **ENGINE_KW))
    assert _spec_stream(jsp, PROMPTS, n) == want
    sp = _spec_pp(tm, tp=2)
    assert _spec_stream(sp, PROMPTS, n) == want
    assert sp.decode_write_tokens == 4
    caps = sp.capture_counts
    assert caps["draft_decode"] == 1
    assert caps["verify_stage[0]"] == caps["verify_stage[1]"] == 1
    assert not any(k.startswith("decode") or k == "spec_verify"
                   for k in caps)
    assert all(v == 1 for v in caps.values())
    acc_pp, acc_sp = pp.hbm_accounting(), sp.hbm_accounting()
    assert acc_sp["per_shard"]["draft"]["device"] == "cpu"
    assert acc_sp["weights_total"] > acc_pp["weights_total"]
    assert acc_sp["kv_total"] > acc_pp["kv_total"]


def test_host_masters_serve_and_swap(models):
    """The engine's master copy lives on the host and the draft holds a
    copy of its own; serving replays deterministically, and a swap from
    the model's state_dict refreshes the stages and the draft in place
    and keeps the stream."""
    _, tm = models
    eng = _spec_pp(tm)
    before = _spec_stream(eng, [PROMPTS[0]], 8)[0]
    assert all(t.device.type == "cpu" for t in eng._params.values())
    assert all(eng._draft_params[n] is not eng._params[n]
               for n in eng._draft_shared)
    eng.reset_slot(0)
    assert _spec_stream(eng, [PROMPTS[0]], 8)[0] == before
    storage = [t.data_ptr() for t in eng._draft_params.values()]
    eng.swap_params({k: v.detach().clone()
                     for k, v in tm.state_dict().items()})
    assert storage == [t.data_ptr() for t in eng._draft_params.values()]
    eng.reset_slot(0)
    assert _spec_stream(eng, [PROMPTS[0]], 8)[0] == before


def test_run_record_engine_fields(models, tmp_path):
    """The scheduler's run record names the engine kind, its (tp, pp)
    shape and gamma, and the spec counters carry `engine=spec_pp`."""
    _, tm = models
    path = str(tmp_path / "m.jsonl")
    sched = Scheduler(_spec_pp(tm), ServingConfig(
        default_max_new_tokens=5, metrics_path=path), device="cpu")
    h = sched.submit(_prompt(230, 8))
    while sched.step():
        pass
    assert h.status == "DONE" and h.spec_proposed > 0
    records = [json.loads(line) for line in open(path)]
    run = next(r for r in records if r["kind"] == "run")
    assert (run["engine"], run["gamma"], run["pp"]) == ("spec_pp", 3, 2)
    flat = tmetrics.flatten_snapshot(tmetrics.registry().snapshot(),
                                     kinds=("counter",))
    assert flat.get("serving_spec_proposed_total{engine=spec_pp}", 0) > 0


def test_spec_pp_scheduler_preemption_and_eos_exact(models):
    """Through the scheduler: preemption under an oversubscribed pool and
    an eos accepted mid-window both cut the streams where the one-token
    loop would; no block leaks."""
    _, tm = models
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 1000, 6).tolist() for _ in range(4)]
    eng = _spec_pp(tm, max_len=32, block_size=4, num_blocks=6,
                   enable_prefix_cache=False)
    sched = Scheduler(eng, max_queue=16, device="cpu")
    hs = [sched.submit(p, max_new_tokens=6) for p in prompts]
    sched.run_until_idle()
    assert sched.counts["serving.preempted"] > 0
    for h, p in zip(hs, prompts):
        assert h.status == "DONE", (h.status, h.error)
        assert h.tokens == _reference(tm, p, 6)
    assert eng.block_pool.in_use == 0
    prompt = _prompt(240, 6)
    base = _reference(tm, prompt, 8)
    eos = base[3]
    want = _reference(tm, prompt, 8, eos=eos)
    assert len(want) < len(base)
    eng2 = _spec_pp(tm, gamma=4, eos_token_id=eos)
    sched2 = Scheduler(eng2, max_queue=4, device="cpu")
    h2 = sched2.submit(prompt, max_new_tokens=8)
    sched2.run_until_idle()
    assert h2.status == "DONE" and h2.tokens == want


def test_spec_pp_int8_swap_handoff_compose(models):
    """int8 KV and weights on the ring equal the JAX int8 spec x pp
    engine; on the float ring a swap mid-stream keeps the stream, the
    slot's generation index counts every emitted token, and a mid-stream
    bundle adopts onto one device and continues exactly."""
    jm, tm = models
    prompt = _prompt(250, 10)
    q = dict(kv_dtype="int8", weight_dtype="int8")
    jq = JSpecPPEngine(jm, JSpecPPConfig(pp=2, gamma=3, draft_layers=1,
                                         **ENGINE_KW, **q))
    assert _spec_stream(_spec_pp(tm, **q), [prompt], 9) == \
        _spec_stream(jq, [prompt], 9)
    want = _one_token(PagedGenerationEngine(tm, device="cpu", **ENGINE_KW),
                      [prompt], 14)[0]
    sp = _spec_pp(tm)
    got = [sp.prefill(0, prompt)]
    toks, n_emit = sp.decode_many()
    got += [int(t) for t in toks[0, :int(n_emit[0])]]
    sp.swap_params({k: v.detach().clone()
                    for k, v in tm.state_dict().items()})
    toks, n_emit = sp.decode_many()
    got += [int(t) for t in toks[0, :int(n_emit[0])]]
    assert got == want[:len(got)]
    assert sp.slot_rng(0)[1] == len(got)
    ks, vs, plen = sp.extract_kv(0)
    b = PagedGenerationEngine(tm, device="cpu", **ENGINE_KW)
    b.adopt_kv(0, ks, vs, plen, got[-1], rng=sp.slot_rng(0))
    cont = []
    for _ in range(3):
        b.ensure_decode_capacity()
        cont.append(int(b.decode()[0]))
    assert cont == want[len(got):len(got) + 3]


def test_spec_pp_make_engine_and_gencfg_roundtrip(models, tmp_path):
    """`make_engine` rebuilds the spec x pp engine from its kind and config
    dict, and the recorded executable set is the engine's, the JAX
    engine's names, and the pp set plus the speculative executables."""
    jm, tm = models
    cfg = PipelineParallelSpecConfig(pp=2, gamma=2, **ENGINE_KW)
    eng = make_engine(tm, "spec_pp", cfg.as_dict(), device="cpu")
    assert type(eng) is PipelineParallelSpeculativeEngine
    assert (eng.config.gamma, eng.config.pp) == (2, 2)
    names = _executable_set("spec_pp", cfg)
    assert names == eng.executable_names()
    assert {"verify_stage[0]", "verify_stage[1]", "draft_decode",
            "decode_stage[0]"} <= set(names)
    assert _executable_set("pp", cfg) == \
        [n for n in names if not n.startswith(("draft", "verify"))]
    jeng = JSpecPPEngine(jm, JSpecPPConfig(pp=2, gamma=2, **ENGINE_KW))
    assert names == jeng.executable_names()
    prefix = str(tmp_path / "sp")
    save_for_generation(tm, prefix, engine_config=cfg)
    meta = json.load(open(prefix + ".gencfg"))
    assert meta["serving"]["engine"] == "spec_pp"
    assert meta["serving"]["executables"] == names
    prompt = _prompt(260, 8)
    ref = PipelineParallelPagedEngine(
        tm, PipelineParallelEngineConfig(pp=2, **ENGINE_KW), device="cpu")
    assert _spec_stream(eng, [prompt], 7)[0] == \
        _one_token(ref, [prompt], 7)[0]


def test_spec_pp_taps_disabled_bit_identical_enabled_captures_once(models):
    """Numerics taps on the spec x pp engine: armed or not, the same
    streams and capture counts; the armed rounds ingest each stage's hop
    activation and the verify window's logits, all finite."""
    _, tm = models
    rows, caps, engs = [], [], []
    for armed in (False, True):
        eng = _spec_pp(tm, tp=2, numerics_taps=armed)
        rows.append(_spec_stream(eng, PROMPTS, 7))
        caps.append(dict(eng.capture_counts))
        engs.append(eng)
    assert rows[0] == rows[1] and caps[0] == caps[1]
    on = engs[1]
    assert engs[0].numerics_monitor is None
    sites, ingest = set(), on._ingest_numerics

    def spy(sink):
        sites.update(sink)
        ingest(sink)
    on._ingest_numerics = spy
    on.decode_many()
    assert {"stage0.act", "spec.verify_logits"} <= sites
    assert on.numerics_monitor.total() == 0
    for site, st in on.last_numerics.items():
        assert st["finite_frac"] == 1.0, (site, st)
