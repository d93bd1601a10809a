"""The port's serving fleet against the JAX one-process scheduler, on the CPU.

The JAX tiny GPT (hidden 128, 2 layers, 4 heads, vocab 1024) is built from
a fixed seed; every port model is a fresh `gpt_tiny(device="cpu")` with
those weights (`load_jax_params`), one per in-process worker. THE oracle
is the JAX `Scheduler` over one JAX paged engine (gather path) serving
the same prompts greedily in one process; every fleet run must match it
token for token (after `tests/test_serving_dist.py`, whose counterparts
of these tests are mostly in the slow tier):

  * disaggregated pools: a prefill worker streams each request's KV
    bundle to one of two decode workers over the fabric;
  * handoff chaos (`serving.kv_handoff`) degrades to a decode-local
    prefill, the streams unchanged;
  * a killed decode worker's requests fail over to the survivor, the
    delivered prefix kept; under temperature > 0 the merged stream is an
    unkilled port run's (token n samples with the generator of
    (rng_seed, n) wherever it runs);
  * a same-weights hot swap mid-traffic through the scheduler and the
    fleet SWAP verb: zero drops, streams unchanged, versions flipped;
  * HEALTH and DRAIN round-trip; a gray (slow) worker is suspected and
    its streams migrate; a rolling drain drops nothing; the decision
    trail replays;
  * cross-package: a JAX `DistFrontend` drives port workers and a port
    `DistFrontend` drives JAX workers;
  * tenancy: a worker armed with a `TenancyConfig` rate-limits a tenant
    and keys its prefix namespace, and a SUBMIT's `adapter_id` binds the
    engine's adapter row (the stream is a local adapted engine's);
  * KV tiers: a chain demoted to a worker's host tier counts in its
    PREFIXLOOKUP, and its KVEXPORT (tier records sha-checked) restores
    on the other worker ahead of the request's prefill, the stream the
    oracle's;
  * prefix-affinity placement with a wire restore (the reference's
    `test_fleet_wire_restore_cross_host`): with zero load slack the
    router places a warm prompt on the worker without its chain, which
    restores it from the worker that has it (`restored_from` in the
    place record, a `kv_restore` timeline phase), the stream the
    oracle's; port router over port workers, and across the packages
    both ways;
  * `worker_main` as a process: it publishes its endpoint, serves,
    exports its spans under the caller's trace id and exits 0 on STOP
    with its exit line, and without `--device cpu` on a machine without
    CUDA it exits non-zero.

Metric values are read as deltas: registries are process-global.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.observability import decisions as jdec
from paddle_tpu.observability import faults as jfaults
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.serving import PagedEngineConfig as JPagedEngineConfig
from paddle_tpu.serving import PagedGenerationEngine as JPagedEngine
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving.distributed import DistFrontend as JDistFrontend
from paddle_tpu.serving.distributed import ServingWorker as JServingWorker
from paddle_tpu.text.models import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.observability import decisions as tdec
from paddle_tpu_torch.observability import faults as tfaults
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import tracecontext as ttc
from paddle_tpu_torch.serving import (PagedEngineConfig,
                                      PagedGenerationEngine, Scheduler,
                                      ServingConfig, make_engine)
from paddle_tpu_torch.serving.distributed import (
    DistFrontend, ServingShardClient, ServingWorker, load_checkpoint_params,
    save_swap_checkpoint)
from paddle_tpu_torch.distributed.ps.rpc import PSServerError
from paddle_tpu_torch.serving.tenancy import (AdapterBank, TenancyConfig,
                                              TenantSpec, init_adapter_state)
from paddle_tpu_torch.text.models import gpt_tiny
from paddle_tpu_torch.text.models.convert import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 1024
ENGINE_KW = dict(slots=2, max_len=64, block_size=8)


@pytest.fixture(scope="module")
def jax_tiny():
    paddle_tpu.seed(11)
    m = jgpt_tiny()
    m.eval()
    return m


@pytest.fixture(scope="module")
def params(jax_tiny):
    return {k: np.asarray(v) for k, v in jax_tiny.state_dict().items()}


@pytest.fixture(scope="module")
def oracle(jax_tiny):
    """prompts, max_new -> {tuple(prompt): JAX one-process greedy stream},
    over one JAX engine (compiled once for the module)."""
    engine = JPagedEngine(jax_tiny, JPagedEngineConfig(
        attention_impl="gather", **ENGINE_KW))

    def run(prompts, max_new):
        sched = JScheduler(engine, JServingConfig(
            default_max_new_tokens=max_new))
        handles = [sched.submit(p) for p in prompts]
        while sched.step():
            pass
        assert all(h.status == "DONE" for h in handles)
        return {tuple(p): h.tokens for p, h in zip(prompts, handles)}
    return run


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.disarm_all()
    tfaults.disarm_all()
    yield
    jfaults.disarm_all()
    tfaults.disarm_all()


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, VOCAB, n).tolist()


def _model(params):
    return load_jax_params(gpt_tiny(device="cpu"), params)


def _engine(model, **over):
    return PagedGenerationEngine(model, PagedEngineConfig(
        **dict(ENGINE_KW, **over)), device="cpu")


def _worker(params, role, max_new=8, step_interval_s=0.0, **engine_over):
    m = _model(params)
    return ServingWorker(m, _engine(m, **engine_over), role=role,
                         serving_config=ServingConfig(
                             default_max_new_tokens=max_new),
                         step_interval_s=step_interval_s)


def _counter(name, **labels):
    flat = tmetrics.flatten_snapshot(tmetrics.registry().snapshot(),
                                     kinds=("counter",))
    key = name
    if labels:
        key += "{" + ",".join(f"{k}={labels[k]}"
                              for k in sorted(labels)) + "}"
    return flat.get(key, 0.0)


def _pump_until(fe, cond, timeout_s=60):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        fe.pump()
        if cond():
            return True
        time.sleep(0.01)
    return False


def _close(fe, workers):
    fe.close()
    for w in workers:
        w.shutdown()


def test_make_engine_kinds(params):
    m = _model(params)
    assert isinstance(make_engine(m, "paged", ENGINE_KW, device="cpu"),
                      PagedGenerationEngine)
    spec = make_engine(m, "spec", dict(ENGINE_KW, gamma=2),
                       device="cpu")
    assert spec.config.gamma == 2
    dense = make_engine(m, "dense", dict(slots=2, max_len=64),
                        device="cpu")
    assert dense.trace_counts == {} and dense.slot_rng(0) == (0, 0)
    from paddle_tpu_torch.serving.distributed import (
        PipelineParallelPagedEngine, PipelineParallelSpeculativeEngine,
        TensorParallelPagedEngine)
    for kind, cls in (("tp", TensorParallelPagedEngine),
                      ("pp", PipelineParallelPagedEngine),
                      ("spec_pp", PipelineParallelSpeculativeEngine)):
        eng = make_engine(m, kind, ENGINE_KW, device="cpu")
        assert type(eng) is cls
        assert eng.config.tp * getattr(eng.config, "pp", 1) == 2
    with pytest.raises(ValueError, match="unknown serving engine kind"):
        make_engine(m, "bogus", ENGINE_KW, device="cpu")
    tiered = make_engine(m, "paged", dict(ENGINE_KW, enable_kv_tiers=True,
                                          host_tier_blocks=4), device="cpu")
    assert tiered.kv_tiers.host.capacity == 4
    assert tiered.trace_counts == {"tier_restore": 0}
    # a tenancy config arms the decode scheduler (it raised before the
    # tenancy slice)
    cfg = TenancyConfig(tenants={"t": TenantSpec(namespace="ns-t",
                                                 kv_block_quota=2)})
    w = ServingWorker(m, _engine(m), tenancy=cfg)
    try:
        assert w.scheduler._tenancy is cfg
        assert w.engine.prefix_cache._quotas == {"ns-t": 2}
    finally:
        w.shutdown()


def test_disaggregated_pools_token_exact(params, oracle):
    prompts = [_prompt(10 + i, 7 + i) for i in range(4)]
    max_new = 5
    want = oracle(prompts, max_new)
    bytes_before = _counter("serving_kv_handoff_bytes_total")
    workers = [_worker(params, "prefill")]
    workers += [_worker(params, "decode", max_new, step_interval_s=0.02)
                for _ in range(2)]
    fe = DistFrontend([w.endpoint for w in workers[1:]],
                      [workers[0].endpoint])
    try:
        reqs = [fe.submit(p, max_new=max_new) for p in prompts]
        fe.run(timeout_s=90)
        for r in reqs:
            assert r.status == "DONE", (r.status, r.error)
            assert r.staged, "remote prefill handoff did not stick"
            assert r.tokens == want[tuple(r.prompt)]
        assert {r.worker for r in reqs} == {0, 1}, "placement collapsed"
        assert _counter("serving_kv_handoff_bytes_total") > bytes_before
        assert tdec.validate_records(fe.decision_records()) == []
    finally:
        _close(fe, workers)


def test_handoff_chaos_degrades_to_recompute(params, oracle):
    """`serving.kv_handoff` fires once per pack and once per unpack:
    nth=1 with max_fires=2 refuses the first two handoffs at the sender,
    and those requests prefill on the decode worker instead."""
    prompts = [_prompt(30 + i, 8) for i in range(4)]
    max_new = 4
    want = oracle(prompts, max_new)
    pw = _worker(params, "prefill")
    dw = _worker(params, "decode", max_new)
    fe = DistFrontend([dw.endpoint], [pw.endpoint])
    tfaults.arm("serving.kv_handoff", mode="raise", nth=1, max_fires=2)
    try:
        reqs = [fe.submit(p, max_new=max_new) for p in prompts]
        fe.run(timeout_s=90)
        for r in reqs:
            assert r.status == "DONE", (r.status, r.error)
            assert r.tokens == want[tuple(r.prompt)]
        assert [r.staged for r in reqs] == [False, False, True, True]
    finally:
        tfaults.disarm_all()
        _close(fe, [pw, dw])


def test_failover_to_live_worker_token_exact(params, oracle):
    prompts = [_prompt(40 + i, 6) for i in range(4)]
    max_new = 12
    want = oracle(prompts, max_new)
    failover_before = _counter("serving_failover_total")
    d0 = _worker(params, "decode", max_new, step_interval_s=0.03)
    d1 = _worker(params, "decode", max_new, step_interval_s=0.03)
    fe = DistFrontend([d0.endpoint, d1.endpoint])
    try:
        reqs = [fe.submit(p, max_new=max_new) for p in prompts]
        victims = [r for r in reqs if r.worker == 1]
        assert victims, "placement never used worker 1"
        assert _pump_until(fe, lambda: all(len(r.tokens) >= 2
                                           for r in victims))
        mid = {r.key: list(r.tokens) for r in victims}
        d1.kill()                       # sever connections like a dead host
        fe.run(timeout_s=90)
        for r in reqs:
            assert r.status == "DONE", (r.status, r.error)
            assert r.tokens == want[tuple(r.prompt)], \
                f"{r.key} diverged after failover"
        for r in victims:
            assert r.failovers >= 1
            assert r.tokens[:len(mid[r.key])] == mid[r.key]
        assert _counter("serving_failover_total") > failover_before
        recs = fe.decision_records()
        assert any(r["action"] == "failover" for r in recs)
        assert tdec.validate_records(recs) == []
    finally:
        _close(fe, [d0, d1])


def test_sampled_failover_is_an_unkilled_port_run(params):
    """temperature > 0: the router pins each request's rng_seed, and the
    restart samples token n with the generator of (rng_seed, n), so the
    merged stream equals one scheduler's unkilled run."""
    sampling = dict(decode_strategy="sampling", temperature=0.9, top_k=50)
    prompts = [_prompt(70 + i, 6) for i in range(4)]
    seeds = [1000 + i for i in range(4)]
    max_new = 12
    ref = Scheduler(_engine(_model(params), **sampling),
                    ServingConfig(default_max_new_tokens=max_new),
                    device="cpu")
    handles = [ref.submit(p, rng_seed=s) for p, s in zip(prompts, seeds)]
    while ref.step():
        pass
    want = [h.tokens for h in handles]
    d0 = _worker(params, "decode", max_new, step_interval_s=0.03,
                 **sampling)
    d1 = _worker(params, "decode", max_new, step_interval_s=0.03,
                 **sampling)
    fe = DistFrontend([d0.endpoint, d1.endpoint])
    try:
        reqs = [fe.submit(p, max_new=max_new, rng_seed=s)
                for p, s in zip(prompts, seeds)]
        victims = [r for r in reqs if r.worker == 1]
        assert victims
        assert _pump_until(fe, lambda: all(len(r.tokens) >= 3
                                           for r in victims))
        d1.kill()
        fe.run(timeout_s=90)
        assert [r.status for r in reqs] == ["DONE"] * 4
        assert all(r.failovers >= 1 for r in victims)
        assert [r.tokens for r in reqs] == want
    finally:
        _close(fe, [d0, d1])


def test_hot_swap_mid_traffic_zero_drops(params, oracle, tmp_path):
    prompts = [_prompt(50 + i, 7) for i in range(3)]
    max_new = 10
    want = oracle(prompts, max_new)
    model = _model(params)
    ckpt = str(tmp_path / "ckpt" / "step-0001")
    assert save_swap_checkpoint(model.state_dict(), ckpt)
    engine = _engine(model)
    sched = Scheduler(engine, ServingConfig(default_max_new_tokens=max_new),
                      device="cpu")
    handles = [sched.submit(p) for p in prompts]
    for _ in range(3):
        sched.step()
    assert any(h.status == "RUNNING" for h in handles)
    ptrs = {n: t.data_ptr() for n, t in engine._params.items()}
    ev = sched.schedule_weight_swap(load_checkpoint_params(ckpt), version=2)
    while sched.step():
        pass
    assert ev.is_set() and sched.last_swap["ok"], sched.last_swap
    assert sched.last_swap["inflight"] >= 1
    assert sched.model_version == 2
    for p, h in zip(prompts, handles):
        assert h.status == "DONE" and h.tokens == want[tuple(p)]
    # the swap copied into the storage the executables read
    assert ptrs == {n: t.data_ptr() for n, t in engine._params.items()}


def test_fleet_swap_verb_flips_every_version(params, oracle, tmp_path):
    max_new = 4
    prompts = [_prompt(80 + i, 6) for i in range(2)]
    want = oracle(prompts, max_new)
    ckpt = str(tmp_path / "ckpt" / "step-0003")
    assert save_swap_checkpoint(_model(params).state_dict(), ckpt)
    pw = _worker(params, "prefill")
    dw = _worker(params, "decode", max_new)
    fe = DistFrontend([dw.endpoint], [pw.endpoint])
    try:
        r0 = fe.submit(prompts[0], max_new=max_new)
        fe.run(timeout_s=60)
        out = fe.swap_all(ckpt, version=5)
        assert all(rep.get("ok") for rep in out.values()), out
        assert {s["version"] for s in fe.stats().values()} == {5}
        r1 = fe.submit(prompts[1], max_new=max_new)
        fe.run(timeout_s=60)
        assert r0.tokens == want[tuple(prompts[0])]
        assert r1.status == "DONE" and r1.staged
        assert r1.tokens == want[tuple(prompts[1])]
    finally:
        _close(fe, [pw, dw])


def test_health_and_drain_verbs_roundtrip(params):
    w = _worker(params, "decode", 4)
    client = ServingShardClient([w.endpoint])
    try:
        h = client.health(0)
        assert h["role"] == "decode" and h["endpoint"] == w.endpoint
        assert h["draining"] is False
        assert h["queue_depth"] >= 0 and h["inflight"] == 0
        assert "last_step_age_s" in h
        assert client.drain(0, enter=True)["draining"] is True
        assert client.health(0)["draining"] is True
        with pytest.raises(PSServerError, match="draining"):
            client.submit(0, "k0", _prompt(1, 5), max_new=2)
        assert client.drain(0)["draining"] is True     # query form
        assert client.drain(0, enter=False)["draining"] is False
        assert client.submit(0, "k1", _prompt(1, 5), max_new=2,
                             adapter_id="lora-a")["ok"]
    finally:
        client.close()
        w.shutdown()


def test_submit_to_a_busy_worker_is_not_starved(params):
    """The decode loop yields its lock between busy steps: a SUBMIT that
    arrives while eight long streams decode is admitted within a few
    steps, not after the loop happens to lose the race for the lock
    (over a second on the CPU without the yield)."""
    w = _worker(params, "decode", 40, slots=8, max_len=64)
    client = ServingShardClient([w.endpoint])
    try:
        waits, yields = [], []
        for i in range(8):
            t0 = time.perf_counter()
            y0 = w.loop_yields
            assert client.submit(0, f"k{i}", _prompt(300 + i, 8),
                                 max_new=40)["ok"]
            waits.append(time.perf_counter() - t0)
            yields.append(w.loop_yields - y0)
        # the loop's busy steps (each ends in a yield) while a SUBMIT
        # waited: many of them mean a lock that starves the handler, few
        # with a long wait a loaded host
        print(f"waits {waits} loop yields {yields}")
        assert max(waits) < 0.5, (waits, yields)
    finally:
        client.close()
        w.shutdown()


def test_gray_slow_worker_suspected_and_migrated(params, oracle):
    prompts = [_prompt(200 + i, 6) for i in range(4)]
    max_new = 20
    want = oracle(prompts, max_new)
    mig_before = _counter("serving_migrations_total", reason="suspect")
    d0 = _worker(params, "decode", max_new, step_interval_s=0.15)
    d1 = _worker(params, "decode", max_new, step_interval_s=0.15)
    fe = DistFrontend([d0.endpoint, d1.endpoint], health_interval_s=0.1)
    try:
        reqs = [fe.submit(p, max_new=max_new, timeout_s=60)
                for p in prompts]
        victims = [r for r in reqs if r.worker == 1]
        assert victims
        assert _pump_until(fe, lambda: all(len(r.tokens) >= 2
                                           for r in victims))
        mid = {r.key: list(r.tokens) for r in victims}
        # every RPC worker 1 serves now sleeps ~0.3 s; its loop runs on
        tfaults.arm("serving.rpc.serve", mode="slow", delay_s=0.3,
                    target=d1.endpoint)
        fe.run(timeout_s=120)
        for r in reqs:
            assert r.status == "DONE", (r.key, r.status, r.error)
            assert r.tokens == want[tuple(r.prompt)]
        for r in victims:
            assert r.tokens[:len(mid[r.key])] == mid[r.key]
        assert fe._health[1].state != "healthy"
        assert _counter("serving_migrations_total",
                        reason="suspect") > mig_before
        recs = fe.decision_records()
        assert tdec.validate_records(recs) == []
        assert any(r["action"] == "health"
                   and r["outcome"]["state"] != "healthy" for r in recs)
        assert any(r["action"] == "migrate" and r["outcome"]["migrated"]
                   for r in recs)
    finally:
        tfaults.disarm_all()
        _close(fe, [d0, d1])


def test_rolling_drain_zero_drop(params, oracle):
    prompts = [_prompt(220 + i, 6) for i in range(4)]
    max_new = 16
    want = oracle(prompts, max_new)
    d0 = _worker(params, "decode", max_new, step_interval_s=0.03)
    d1 = _worker(params, "decode", max_new, step_interval_s=0.03)
    fe = DistFrontend([d0.endpoint, d1.endpoint], health_interval_s=0.1)
    try:
        reqs = [fe.submit(p, max_new=max_new, timeout_s=60)
                for p in prompts]
        assert {r.worker for r in reqs} == {0, 1}
        assert _pump_until(fe, lambda: all(len(r.tokens) >= 2
                                           for r in reqs))
        report = fe.rolling_drain(timeout_s=60)
        assert set(report) == {d0.endpoint, d1.endpoint}
        assert all(v["drained"] for v in report.values()), report
        fe.run(timeout_s=120)
        for r in reqs:
            assert r.status == "DONE", (r.key, r.status, r.error)
            assert r.tokens == want[tuple(r.prompt)]
        assert fe._draining_workers == set() and fe._live == {0, 1}
        recs = fe.decision_records()
        assert tdec.validate_records(recs) == []
        assert any(r["action"] == "drain" for r in recs)
    finally:
        _close(fe, [d0, d1])


# ------------------------------------------------------------ cross-package

def test_jax_router_drives_port_workers(params, oracle):
    prompts = [_prompt(240 + i, 5 + i) for i in range(3)]
    max_new = 6
    want = oracle(prompts, max_new)
    workers = [_worker(params, "prefill"), _worker(params, "decode",
                                                   max_new)]
    fe = JDistFrontend([workers[1].endpoint], [workers[0].endpoint])
    try:
        reqs = [fe.submit(p, max_new=max_new) for p in prompts]
        fe.run(timeout_s=90)
        for r in reqs:
            assert r.status == "DONE", (r.status, r.error)
            assert r.staged
            assert r.tokens == want[tuple(r.prompt)]
        stat = fe.stats()[workers[1].endpoint]
        assert stat["role"] == "decode" and stat["trace_counts"] == {}
    finally:
        _close(fe, workers)


def test_tenancy_armed_worker(params):
    """A decode worker armed with a TenancyConfig: the tenant's bucket
    denies past its burst (an error frame naming the rate limit), its
    requests key their prefix blocks in its namespace, and a SUBMIT's
    `adapter_id` decodes under that adapter: the stream is a local
    engine's with the adapter bound, and differs from the base one."""
    prompt = _prompt(300, 9)
    max_new = 6
    m = _model(params)
    state = init_adapter_state(m.cfg, 4, seed=1, scale=1.0)

    def local(adapter):
        eng = _engine(_model(params))
        bank = AdapterBank(m.cfg, 2, 4)
        bank.load("acme", state)
        eng.attach_adapters(bank)
        first = eng.prefill(0, prompt)
        eng.set_slot_adapter(0, bank.slot_of("acme") if adapter else 0)
        out = [first]
        for _ in range(max_new - 1):
            eng.ensure_decode_capacity()
            out.append(int(eng.decode()[0]))
        return out
    eng = _engine(m)
    bank = AdapterBank(m.cfg, 2, 4)
    bank.load("acme", state)
    eng.attach_adapters(bank)
    cfg = TenancyConfig(tenants={"acme": TenantSpec(
        namespace="ns-acme", rate_tokens_per_s=0.001,
        burst_tokens=2 * (len(prompt) + max_new))})
    w = ServingWorker(m, eng, serving_config=ServingConfig(
        default_max_new_tokens=max_new), tenancy=cfg)
    fe = DistFrontend([w.endpoint])
    try:
        ra = fe.submit(prompt, max_new=max_new, tenant="acme",
                       adapter_id="acme")
        rb = fe.submit(prompt, max_new=max_new, tenant="acme")
        fe.run(timeout_s=60)
        assert ra.status == rb.status == "DONE", (ra.error, rb.error)
        assert ra.tokens == local(True)
        assert rb.tokens == ra.tokens        # the tenant's adapter binds
        assert local(False) != ra.tokens
        client = ServingShardClient([w.endpoint])
        try:
            with pytest.raises(PSServerError, match="rate limited"):
                client.submit(0, "k-denied", prompt, max_new=max_new,
                              tenant="acme")
        finally:
            client.close()
        assert w.engine.prefix_cache.resident("ns-acme") > 0
    finally:
        _close(fe, [w])


def test_tiered_chain_restores_across_workers(params, oracle):
    """Worker 0 serves a prompt, then demotes its chain to its host tier.
    Its PREFIXLOOKUP still counts those tokens, and its KVEXPORT ships the
    chain (read and sha-checked from the tier, which keeps it) to worker
    1's staging area; worker 1 restores it ahead of the request's prefill
    (a 24-token prefix hit), and the stream is the oracle's. The router's
    placement over the same verbs is the reference's
    `test_fleet_wire_restore_cross_host`; here the verbs are driven
    directly, so no probe deadline decides the path."""
    prompt = _prompt(320, 26)
    max_new = 4
    want = oracle([prompt], max_new)[tuple(prompt)]
    workers = [_worker(params, "decode", max_new, enable_kv_tiers=True,
                       host_tier_blocks=16) for _ in range(2)]
    w0, w1 = workers
    fe = DistFrontend([w0.endpoint])
    client = ServingShardClient([w.endpoint for w in workers])
    try:
        r1 = fe.submit(prompt, max_new=max_new)
        fe.run(timeout_s=60)
        assert r1.tokens == want
        with w0._lock:
            assert w0.engine.prefix_cache.evict(999) == 3
            assert len(w0.engine.kv_tiers.residency()) == 3
        assert client.prefix_lookup(0, prompt)["match_tokens"] == 24
        hits0 = _counter("serving_kv_tier_hits_total", tier="host")
        out = client.kv_export(0, "k-tiered", prompt,
                               decode_endpoint=w1.endpoint)
        assert out["ok"] and out["plen"] == 24 and out["bytes"] > 0
        assert _counter("serving_kv_tier_hits_total", tier="host") \
            == hits0 + 3
        assert len(w0.engine.kv_tiers.residency()) == 3   # peeked, kept
        client.submit(1, "k-tiered", prompt, max_new=max_new,
                      use_staged=True)
        deadline = time.monotonic() + 60
        while True:
            view = client.poll(1, ["k-tiered"])["k-tiered"]
            if view["status"] == "DONE" or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        assert view["status"] == "DONE" and view["tokens"] == want
        with w1._lock:
            assert w1.engine.last_prefill_stats["prefix_hit_tokens"] == 24
        assert "kv_restore" in {p["phase"] for p in view["phases"]}
    finally:
        client.close()
        _close(fe, workers)


def _wire_restore_workers(pkg, params, jax_tiny, max_new):
    """Two decode workers of `pkg` that step every 20 ms."""
    if pkg == "port":
        return [_worker(params, "decode", max_new, step_interval_s=0.02)
                for _ in range(2)]
    workers = []
    for _ in range(2):
        m = jgpt_tiny()
        m.eval()
        m.set_state_dict(jax_tiny.state_dict())
        workers.append(JServingWorker(
            m, JPagedEngine(m, JPagedEngineConfig(attention_impl="gather",
                                                  **ENGINE_KW)),
            role="decode", serving_config=JServingConfig(
                default_max_new_tokens=max_new), step_interval_s=0.02))
    return workers


@pytest.mark.parametrize("router,workers", [("port", "port"),
                                            ("jax", "port"),
                                            ("port", "jax")])
def test_fleet_wire_restore_cross_host(router, workers, params, jax_tiny,
                                       oracle, tmp_path):
    """Worker 0 serves a prompt (its prefix cache warms); a filler keeps
    it busy; the same prompt again probes the fleet, finds the chain on
    worker 0, and zero load slack places it on worker 1, which restores
    0's chain over the wire before its prefill. The stream is the
    oracle's, the place record names `restored_from`, the restore is a
    timeline phase, and every decision replays."""
    prompt = _prompt(46, 26)
    filler = _prompt(47, 26)
    max_new = 4
    want = oracle([prompt], max_new)[tuple(prompt)]
    tl = str(tmp_path / "timeline.jsonl")
    metrics_mod = tmetrics if workers == "port" else jmetrics
    flat = metrics_mod.flatten_snapshot(metrics_mod.registry().snapshot(),
                                        kinds=("counter",))
    bytes0 = flat.get("serving_kv_handoff_bytes_total", 0.0)
    ws = _wire_restore_workers(workers, params, jax_tiny, max_new)
    frontend = DistFrontend if router == "port" else JDistFrontend
    # the affinity probe of a worker that has not answered within
    # 2 * hedge delay claims no match; the hedge delay follows the RTTs
    # seen, from 20 ms up, and a busy worker answers PREFIXLOOKUP between
    # its decode steps, which take longer than that on a loaded host. The
    # floor at the default ceiling (0.5 s) keeps the probe's answer, not
    # the host's load, deciding the placement
    fe = frontend([w.endpoint for w in ws], timeline_path=tl,
                  prefix_affinity=True,
                  affinity_min_match=ENGINE_KW["block_size"],
                  affinity_load_slack=0, hedge_delay_min_s=0.5)
    try:
        r1 = fe.submit(prompt, max_new=max_new)
        assert r1.worker == 0              # no match anywhere: a tie, 0
        fe.run(timeout_s=60)
        assert r1.status == "DONE" and r1.tokens == want
        rf = fe.submit(filler, max_new=30)  # keeps worker 0 loaded
        assert rf.worker == 0
        r2 = fe.submit(prompt, max_new=max_new)
        fe.run(timeout_s=60)
        assert r2.status == "DONE", (r2.status, r2.error)
        assert r2.worker == 1, "slack fallback did not move the request"
        assert r2.tokens == want, "wire-restored stream diverged"
        flat = metrics_mod.flatten_snapshot(
            metrics_mod.registry().snapshot(), kinds=("counter",))
        assert flat.get("serving_kv_handoff_bytes_total", 0.0) > bytes0
        recs = fe.decision_records()
        validate = tdec.validate_records if router == "port" \
            else jdec.validate_records
        assert validate(recs) == []
        place = [r for r in recs if r["action"] == "place"
                 and r["key"] == r2.key][0]
        assert str(place["outcome"].get("restored_from")) == "0"
        assert place["inputs"]["matches"], "affinity probe recorded nothing"
    finally:
        _close(fe, ws)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import serve_report
    records = serve_report.load(tl)
    assert serve_report.validate_records(records) == []
    r2_tl = [r for r in records if r.get("kind") == "timeline"
             and r.get("key") == r2.key][0]
    assert "kv_restore" in {p["phase"] for p in r2_tl["phases"]}


def test_port_router_drives_jax_workers(jax_tiny, oracle):
    prompts = [_prompt(260 + i, 5 + i) for i in range(3)]
    max_new = 6
    want = oracle(prompts, max_new)
    workers = []
    for role in ("prefill", "decode"):
        m = jgpt_tiny()
        m.eval()
        m.set_state_dict(jax_tiny.state_dict())
        workers.append(JServingWorker(
            m, JPagedEngine(m, JPagedEngineConfig(attention_impl="gather",
                                                  **ENGINE_KW)),
            role=role, serving_config=JServingConfig(
                default_max_new_tokens=max_new)))
    fe = DistFrontend([workers[1].endpoint], [workers[0].endpoint])
    try:
        reqs = [fe.submit(p, max_new=max_new) for p in prompts]
        fe.run(timeout_s=120)
        for r in reqs:
            assert r.status == "DONE", (r.status, r.error)
            assert r.staged
            assert r.tokens == want[tuple(r.prompt)]
        assert tdec.validate_records(fe.decision_records()) == []
    finally:
        _close(fe, workers)


# ---------------------------------------------------- worker_main process

def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PTN_FAULTS", "PTN_TRACE_EXPORT_DIR")}
    env["PYTHONPATH"] = ROOT
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_worker_main_serves_and_stops(tmp_path):
    """One worker process: it publishes its endpoint, serves a request
    token-exact against the same seed in this process, exports its host
    spans under the router's trace id (`PTN_TRACE_EXPORT_DIR`), and exits
    0 on STOP with its exit line."""
    ep_file = str(tmp_path / "dec0.ep")
    env = dict(_env(), PTN_TRACE_EXPORT_DIR=str(tmp_path / "trace"))
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "paddle_tpu_torch.serving.distributed.worker_main",
         "--device", "cpu", "--model", "gpt_tiny", "--seed", "3",
         "--engine-config", json.dumps(ENGINE_KW),
         "--serving-config", json.dumps({"default_max_new_tokens": 4}),
         "--endpoint-file", ep_file],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    fe = None
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(ep_file):
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            assert time.monotonic() < deadline, "no endpoint published"
            time.sleep(0.05)
        endpoint = open(ep_file).read().strip()
        fe = DistFrontend([endpoint])
        prompt = _prompt(5, 6)
        with ttc.trace_scope() as tid:
            r = fe.submit(prompt, max_new=4)
        fe.run(timeout_s=60)
        assert r.status == "DONE" and len(r.tokens) == 4
        # the same seed in this process gives the same stream
        sched = Scheduler(_engine(gpt_tiny(device="cpu", seed=3)),
                          ServingConfig(default_max_new_tokens=4),
                          device="cpu")
        h = sched.submit(prompt)
        while sched.step():
            pass
        assert r.tokens == h.tokens
        fe.stop_workers()
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err[-3000:]
        line = [ln for ln in err.splitlines()
                if ln.startswith("worker_main exit: ")][-1]
        info = json.loads(line[len("worker_main exit: "):])
        assert info["device"] == "cpu" and info["engine"] == "paged"
        assert info["attention_impl"] == "kernel"
        assert info["capture_counts"] == {}
        (path,) = (tmp_path / "trace").iterdir()
        spans = [e for e in json.loads(path.read_text())["traceEvents"]
                 if e.get("ph") == "X"]
        submit = [e for e in spans if e["name"] == "ps.server::SUBMIT"]
        assert submit and submit[0]["args"]["trace_id"] == tid
        assert any(e["name"] == "serving::decode_step" for e in spans)
    finally:
        if fe is not None:
            fe.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_worker_main_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the worker would start")
    r = subprocess.run(
        [sys.executable, "-m",
         "paddle_tpu_torch.serving.distributed.worker_main",
         "--model", "gpt_tiny", "--endpoint-file",
         str(tmp_path / "ep")], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert not os.path.exists(tmp_path / "ep")
