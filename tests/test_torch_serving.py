"""The port's serving slice against the JAX package, on the CPU.

The JAX tiny GPT (hidden 128, 2 layers, 4 heads, vocab 1024) is built from
a fixed seed and its weights are carried into the port with
`load_jax_params`. Then:

  * model: the port's paged cached logits agree with the JAX model's
    logits over the same tokens within atol 1e-4 (float32; the two
    frameworks sum in other orders);
  * engines: greedy streams are token-exact against the JAX
    `PagedGenerationEngine(attention_impl="kernel")` (its Pallas kernel in
    interpret mode) and the dense `GenerationEngine`, at prompt lengths
    1, 7, 8, 9, 17, 31 and through a ragged retire and refill. Every
    compared step's top-2 logit gap is asserted to be at least 1e-4, so
    no comparison sits on a near-tie;
  * scheduler: requests are answered, and a BlockAllocError (forced, or
    from a tight pool) preempts and requeues without changing a stream;
  * isolation: `paddle_tpu_torch` and `chip_smoke.py` import neither JAX
    nor `paddle_tpu` (checked in a subprocess, since this process imports
    both), and an entry point left at its default device raises without
    CUDA.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.serving import GenerationEngine as JGenerationEngine
from paddle_tpu.serving import PagedGenerationEngine as JPagedEngine
from paddle_tpu.serving import prefix_cache as jprefix
from paddle_tpu.serving import kv_cache as jkvc
from paddle_tpu.text.models import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.serving import (BlockAllocError, GenerationEngine,
                                      PagedGenerationEngine, Scheduler,
                                      SpeculativeEngine)
from paddle_tpu_torch.serving import kv_cache as tkvc
from paddle_tpu_torch.serving import prefix_cache as tprefix
from paddle_tpu_torch.serving import sampling
from paddle_tpu_torch.text.models import gpt_tiny
from paddle_tpu_torch.text.models.convert import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENGTHS = (1, 7, 8, 9, 17, 31)
MIN_GAP = 1e-4          # a top-2 logit gap below this is a near-tie
ENGINE = dict(slots=2, max_len=64)
PAGED = dict(block_size=8)


@pytest.fixture(scope="module")
def models():
    """(JAX tiny GPT, the port's tiny GPT on the CPU with its weights)."""
    paddle_tpu.seed(7)
    jm = jgpt_tiny()
    jm.eval()
    params = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = load_jax_params(gpt_tiny(device="cpu"), params)
    return jm, tm


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 1000, n)


class _GapRecorder:
    """Wraps a port engine's token selection to record the top-2 logit gap
    of every row it picks from."""

    def __init__(self, eng):
        self.gaps = []
        sel, sel_slots = eng._select, eng._select_slots

        def gap(logits):
            top = torch.topk(logits.float(), 2, dim=-1).values
            return (top[..., 0] - top[..., 1]).reshape(-1).tolist()

        def rec_select(logits, slot):
            self.gaps.extend(gap(logits))
            return sel(logits, slot)

        def rec_slots(logits, picks=None):
            self.gaps.extend(gap(logits))
            return sel_slots(logits, picks)
        eng._select, eng._select_slots = rec_select, rec_slots

    def assert_no_near_tie(self):
        assert self.gaps and min(self.gaps) >= MIN_GAP, \
            f"a compared step sits on a near-tie: min gap {min(self.gaps)}"


def _run_pairs(eng, steps=5):
    """Each pair of LENGTHS prompts: prefill both slots, decode `steps`
    times, reset; returns the streams."""
    streams = []
    for i in range(0, len(LENGTHS), 2):
        pair = [_prompt(20 + i + j, LENGTHS[i + j]) for j in range(2)]
        rows = [[eng.prefill(s, p)] for s, p in enumerate(pair)]
        for _ in range(steps):
            out = eng.decode()
            for s in range(2):
                rows[s].append(int(out[s]))
        for s in range(2):
            eng.reset_slot(s)
        streams.append(rows)
    return streams


def _ragged(eng):
    """Retire slot 0 mid-flight and refill it at another length."""
    eng.prefill(0, _prompt(0, 9))
    eng.prefill(1, _prompt(1, 21))
    rows = [[], []]
    for _ in range(3):
        out = eng.decode()
        for s in range(2):
            rows[s].append(int(out[s]))
    eng.reset_slot(0)
    rows[0].append(eng.prefill(0, _prompt(2, 5)))
    for _ in range(4):
        out = eng.decode()
        for s in range(2):
            rows[s].append(int(out[s]))
    return rows


# ------------------------------------------------------------------- model
def test_load_jax_params_transposes_linears(models):
    jm, tm = models
    w = np.asarray(jm.state_dict()["blocks.0.attn.qkv.weight"])
    np.testing.assert_array_equal(tm.blocks[0].attn.qkv.weight.detach().numpy(), w.T)
    np.testing.assert_array_equal(
        tm.wte.weight.detach().numpy(), np.asarray(jm.state_dict()["wte.weight"]))
    with pytest.raises(ValueError, match="differ"):
        load_jax_params(tm, {"wte.weight": w})


def test_uncached_and_paged_cached_logits_match_jax(models):
    """Prefill 11 tokens into a paged cache (bucket-padded to 16, across a
    block edge), then decode 3 single tokens; each cached logit row must
    match the JAX model's uncached logits at that position."""
    jm, tm = models
    ids = _prompt(3, 14)
    want = np.asarray(jm(paddle_tpu.to_tensor(ids[None].astype(np.int64))))
    got = tm(torch.from_numpy(ids[None].astype(np.int64)))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4,
                               rtol=0)

    from paddle_tpu_torch.serving import blocks
    c = tm.cfg
    pools = blocks.alloc_pools(c.num_layers, 5, 8, c.num_heads,
                               c.hidden_size // c.num_heads, device="cpu")
    tables = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    padded = np.zeros((1, 16), np.int64)
    padded[0, :11] = ids[:11]
    cache = blocks.PagedDecodeCache(pools, tables,
                                    torch.zeros((1,), dtype=torch.int32),
                                    torch.tensor([11], dtype=torch.int32))
    with torch.no_grad():
        logits, _ = tm(torch.from_numpy(padded), cache=cache)
        rows = [logits[0, :11]]
        for t in range(11, 14):
            cache = blocks.PagedDecodeCache(
                pools, tables, torch.tensor([t], dtype=torch.int32))
            step, _ = tm(torch.from_numpy(ids[None, t:t + 1].astype(
                np.int64)), cache=cache)
            rows.append(step[0])
    np.testing.assert_allclose(torch.cat(rows).numpy(), want[0], atol=1e-4,
                               rtol=0)


def test_dense_kv_cache_matches_jax():
    rng = np.random.RandomState(4)
    buf = rng.randn(2, 16, 4, 32).astype(np.float32)
    new = rng.randn(2, 3, 4, 32).astype(np.float32)
    q = rng.randn(2, 3, 4, 32).astype(np.float32)
    pos = np.asarray([2, 14], np.int32)          # 14 clamps to 13
    jbuf = np.asarray(jkvc.write(buf, new, pos))
    tbuf = tkvc.write(torch.from_numpy(buf.copy()), torch.from_numpy(new),
                      torch.from_numpy(pos))
    np.testing.assert_array_equal(tbuf.numpy(), jbuf)
    want = np.asarray(jkvc.attend(q, jbuf, jbuf, pos))
    got = tkvc.attend(torch.from_numpy(q), tbuf, tbuf, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------- engines
def test_greedy_streams_token_exact_vs_jax_kernel_and_dense(models):
    jm, tm = models
    jk = JPagedEngine(jm, attention_impl="kernel", **ENGINE, **PAGED)
    jd = JGenerationEngine(jm, **ENGINE)
    tk = PagedGenerationEngine(tm, attention_impl="kernel", device="cpu",
                               **ENGINE, **PAGED)
    td = GenerationEngine(tm, device="cpu", **ENGINE)
    rec = _GapRecorder(tk)
    want = _run_pairs(jk)
    assert _run_pairs(jd) == want
    assert _run_pairs(tk) == want
    assert _run_pairs(td) == want
    rec.assert_no_near_tie()
    assert tk.kernel_launches == 0          # CPU tensors: the plain version


def test_ragged_retire_and_refill_token_exact(models):
    jm, tm = models
    jk = JPagedEngine(jm, attention_impl="kernel", **ENGINE, **PAGED)
    tk = PagedGenerationEngine(tm, attention_impl="kernel", device="cpu",
                               **ENGINE, **PAGED)
    rec = _GapRecorder(tk)
    assert _ragged(tk) == _ragged(jk)
    rec.assert_no_near_tie()


def test_int8_kv_engine_matches_jax_int8(models):
    """int8 pools: the port's quantizing writes and dequantizing attention
    give the JAX int8 engine's greedy stream."""
    jm, tm = models
    kw = dict(ENGINE, **PAGED, kv_dtype="int8", attention_impl="kernel")
    tk = PagedGenerationEngine(tm, device="cpu", **kw)
    rec = _GapRecorder(tk)
    assert _ragged(tk) == _ragged(JPagedEngine(jm, **kw))
    rec.assert_no_near_tie()


def test_prefix_cache_hit_keeps_stream(models):
    """A second prompt sharing two full blocks reuses them (prefill runs
    only the suffix) and still decodes the cold engine's stream."""
    _, tm = models
    shared = list(_prompt(5, 16))
    p1, p2 = shared + [1, 2, 3], shared + [4, 5]
    warm = PagedGenerationEngine(tm, device="cpu", **ENGINE, **PAGED)
    cold = PagedGenerationEngine(tm, device="cpu", enable_prefix_cache=False,
                                 **ENGINE, **PAGED)
    warm.prefill(0, p1)
    got = [warm.prefill(1, p2)] + [int(warm.decode()[1]) for _ in range(4)]
    assert warm.last_prefill_stats["prefix_hit_tokens"] == 16
    assert warm.prefix_cache.hits == 1
    cold.prefill(0, p1)
    want = [cold.prefill(1, p2)] + [int(cold.decode()[1]) for _ in range(4)]
    assert got == want
    assert tprefix.prefix_key(shared) == jprefix.prefix_key(shared)


def test_sampling_is_a_function_of_seed_and_gen():
    logits = torch.from_numpy(np.random.RandomState(6).randn(3, 50)
                              .astype(np.float32))

    def draw(seed, gen, **kw):
        g = torch.Generator().manual_seed(
            sampling.slot_generator_seed(seed, gen))
        return sampling.select_tokens(logits, g, "sampling", **kw).tolist()
    assert draw(11, 3) == draw(11, 3)
    assert len({tuple(draw(11, g)) for g in range(8)}) > 1
    greedy = sampling.select_tokens(logits).tolist()
    assert draw(11, 0, top_k=1) == greedy
    assert draw(11, 0, top_p=1e-6) == greedy


# --------------------------------------------------------------- scheduler
def _serve(eng, prompts, max_new=6, sched=None):
    sched = sched or Scheduler(eng, device="cpu")
    handles = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    sched.run_until_idle()
    assert all(h.status == "DONE" for h in handles)
    return [h.tokens for h in handles], sched


def test_scheduler_answers_and_forced_preemption_keeps_streams(models):
    _, tm = models
    prompts = [_prompt(30 + i, n) for i, n in enumerate((3, 12, 9, 20))]
    base, sched = _serve(PagedGenerationEngine(tm, device="cpu", **ENGINE,
                                               **PAGED), prompts)
    m = sched.metrics()
    assert m["requests"]["serving.completed"] == 4
    assert m["tokens_generated"] == 24
    assert m["decode_steps"] > 0 and m["decode_step_ms"] > 0

    # the scheduler's growth phase of its third step meets one
    # BlockAllocError: it preempts a slot and requeues the request
    eng = PagedGenerationEngine(tm, device="cpu", **ENGINE, **PAGED)
    sched = Scheduler(eng, device="cpu")
    ensure, grow = eng.ensure_slot_capacity, sched._grow_paged_slots
    armed = []

    def flaky(slot, tokens=None):
        if armed:
            armed.pop()
            raise BlockAllocError("forced")
        return ensure(slot, tokens)

    def grow_with_one_failure():
        if sched._steps == 2:
            armed.append(True)
        grow()
    eng.ensure_slot_capacity = flaky
    sched._grow_paged_slots = grow_with_one_failure
    got, _ = _serve(eng, prompts, sched=sched)
    assert sched.counts["serving.preempted"] == 1
    assert got == base


def test_tight_pool_preempts_without_changing_streams(models):
    """9 blocks of 8 tokens for two slots that each grow to 7 blocks:
    decode growth runs out of blocks and preempts."""
    _, tm = models
    prompts = [_prompt(40 + i, 20) for i in range(3)]
    base, _ = _serve(PagedGenerationEngine(tm, device="cpu", **ENGINE,
                                           **PAGED), prompts, max_new=30)
    got, sched = _serve(PagedGenerationEngine(tm, device="cpu", num_blocks=9,
                                              **ENGINE, **PAGED),
                        prompts, max_new=30)
    assert sched.counts["serving.preempted"] >= 1
    assert got == base


def test_paged_engine_defaults_to_the_kernel_path(models, monkeypatch):
    """Left at its defaults the paged engine attends through the kernel's
    wrapper (its plain version on the CPU) and serves the gather path's
    streams."""
    from paddle_tpu_torch.ops import paged_attention as tpa
    _, tm = models
    calls = []
    wrapped = tpa.paged_attention

    def counting(*a, **kw):
        calls.append(1)
        return wrapped(*a, **kw)
    monkeypatch.setattr(tpa, "paged_attention", counting)
    prompts = [_prompt(50 + i, n) for i, n in enumerate((5, 13))]
    eng = PagedGenerationEngine(tm, device="cpu", **ENGINE, **PAGED)
    assert eng.config.attention_impl == "kernel"
    got, _ = _serve(eng, prompts)
    assert calls
    want, _ = _serve(PagedGenerationEngine(tm, device="cpu",
                                           attention_impl="gather",
                                           **ENGINE, **PAGED), prompts)
    assert got == want


def test_scheduler_queue_cap_and_priority_order(models):
    _, tm = models
    eng = PagedGenerationEngine(tm, device="cpu", slots=1, max_len=64,
                                **PAGED)
    sched = Scheduler(eng, device="cpu", max_queue=2)
    late = sched.submit(_prompt(1, 4), max_new_tokens=2, priority="batch")
    early = sched.submit(_prompt(2, 4), max_new_tokens=2,
                         priority="interactive")
    from paddle_tpu_torch.serving import QueueFullError
    with pytest.raises(QueueFullError):
        sched.submit(_prompt(3, 4))
    sched.drain()
    assert early.done() and late.done()
    assert early._req.finished_at <= late._req.first_token_at


# --------------------------------------------------------------- isolation
def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import importlib, pkgutil, runpy, sys\n"
            "import paddle_tpu_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages(\n"
            "    paddle_tpu_torch.__path__, 'paddle_tpu_torch.')]\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "assert {'paddle_tpu_torch.ops.flash_attention',\n"
            "        'paddle_tpu_torch.parallel.gpt_spmd',\n"
            "        'paddle_tpu_torch.serving.spec_decode',\n"
            "        'paddle_tpu_torch.serving.graphs',\n"
            "        'paddle_tpu_torch.serving.distributed.kv_handoff',\n"
            "        'paddle_tpu_torch.serving.distributed.tp',\n"
            "        'paddle_tpu_torch.serving.distributed.pp',\n"
            "        'paddle_tpu_torch.parallel.pipeline_schedule',\n"
            "        'paddle_tpu_torch.parallel.collectives',\n"
            "        'paddle_tpu_torch.parallel.ring_attention',\n"
            "        'paddle_tpu_torch.parallel.convert',\n"
            "        'paddle_tpu_torch.serving.kv_tiers.store',\n"
            "        'paddle_tpu_torch.serving.kv_tiers.host',\n"
            "        'paddle_tpu_torch.serving.kv_tiers.disk',\n"
            "        'paddle_tpu_torch.serving.tenancy.adapters',\n"
            "        'paddle_tpu_torch.serving.tenancy.limits',\n"
            "        'paddle_tpu_torch.serving.tenancy.registry',\n"
            "        'paddle_tpu_torch.observability.metrics',\n"
            "        'paddle_tpu_torch.observability.tracecontext',\n"
            "        'paddle_tpu_torch.observability.faults',\n"
            "        'paddle_tpu_torch.observability.flight_recorder',\n"
            "        'paddle_tpu_torch.observability.decisions',\n"
            "        'paddle_tpu_torch.observability.reqtimeline',\n"
            "        'paddle_tpu_torch.profiler',\n"
            "        'paddle_tpu_torch.observability.fleet',\n"
            "        'paddle_tpu_torch.observability.kvledger',\n"
            "        'paddle_tpu_torch.observability.numerics',\n"
            "        'paddle_tpu_torch.observability.kineto',\n"
            "        'paddle_tpu_torch.observability.deviceprof',\n"
            "        'paddle_tpu_torch.cost_model',\n"
            "        'paddle_tpu_torch.cost_model.analytical',\n"
            "        'paddle_tpu_torch.profiler.statistic',\n"
            "        'paddle_tpu_torch.framework.ckpt_commit',\n"
            "        'paddle_tpu_torch.framework.io',\n"
            "        'paddle_tpu_torch.framework.flags',\n"
            "        'paddle_tpu_torch.framework.compile_cache',\n"
            "        'paddle_tpu_torch.inference',\n"
            "        'paddle_tpu_torch.distributed.checkpoint',\n"
            "        'paddle_tpu_torch.distributed.ps.rpc',\n"
            "        'paddle_tpu_torch.serving.distributed.worker',\n"
            "        'paddle_tpu_torch.serving.distributed.router',\n"
            "        'paddle_tpu_torch.serving.distributed.worker_main',\n"
            "        'paddle_tpu_torch._kernels.build',\n"
            "        'paddle_tpu_torch.core.tensor',\n"
            "        'paddle_tpu_torch.core.dtype',\n"
            "        'paddle_tpu_torch.core.random',\n"
            "        'paddle_tpu_torch.core.autograd',\n"
            "        'paddle_tpu_torch.autograd',\n"
            "        'paddle_tpu_torch.tensor',\n"
            "        'paddle_tpu_torch.tensor.creation',\n"
            "        'paddle_tpu_torch.tensor.math',\n"
            "        'paddle_tpu_torch.tensor.manipulation',\n"
            "        'paddle_tpu_torch.tensor.logic',\n"
            "        'paddle_tpu_torch.tensor.search',\n"
            "        'paddle_tpu_torch.tensor.stat',\n"
            "        'paddle_tpu_torch.tensor.linalg',\n"
            "        'paddle_tpu_torch.tensor.random',\n"
            "        'paddle_tpu_torch.tensor.einsum',\n"
            "        'paddle_tpu_torch.tensor.inplace',\n"
            "        'paddle_tpu_torch.tensor.extras',\n"
            "        'paddle_tpu_torch.device',\n"
            "        'paddle_tpu_torch.device.cuda',\n"
            "        'paddle_tpu_torch.nn',\n"
            "        'paddle_tpu_torch.nn.param_attr',\n"
            "        'paddle_tpu_torch.nn.initializer',\n"
            "        'paddle_tpu_torch.nn.clip',\n"
            "        'paddle_tpu_torch.nn.layer',\n"
            "        'paddle_tpu_torch.nn.layer.layers',\n"
            "        'paddle_tpu_torch.nn.layer.container',\n"
            "        'paddle_tpu_torch.nn.layer.common',\n"
            "        'paddle_tpu_torch.nn.layer.activation',\n"
            "        'paddle_tpu_torch.nn.layer.norm',\n"
            "        'paddle_tpu_torch.nn.layer.loss',\n"
            "        'paddle_tpu_torch.nn.layer.transformer',\n"
            "        'paddle_tpu_torch.nn.functional',\n"
            "        'paddle_tpu_torch.nn.functional.activation',\n"
            "        'paddle_tpu_torch.nn.functional.common',\n"
            "        'paddle_tpu_torch.nn.functional.norm',\n"
            "        'paddle_tpu_torch.nn.functional.loss',\n"
            "        'paddle_tpu_torch.nn.functional.conv',\n"
            "        'paddle_tpu_torch.nn.functional.extras',\n"
            "        'paddle_tpu_torch.nn.functional.attention',\n"
            "        'paddle_tpu_torch.optimizer',\n"
            "        'paddle_tpu_torch.optimizer.lr',\n"
            "        'paddle_tpu_torch.optimizer.optimizer',\n"
            "        'paddle_tpu_torch.amp',\n"
            "        'paddle_tpu_torch.regularizer',\n"
            "        'paddle_tpu_torch.nn.layer.conv',\n"
            "        'paddle_tpu_torch.nn.layer.pooling',\n"
            "        'paddle_tpu_torch.nn.utils',\n"
            "        'paddle_tpu_torch.native',\n"
            "        'paddle_tpu_torch.io',\n"
            "        'paddle_tpu_torch.io.worker',\n"
            "        'paddle_tpu_torch.batch',\n"
            "        'paddle_tpu_torch.reader',\n"
            "        'paddle_tpu_torch.metric',\n"
            "        'paddle_tpu_torch.callbacks',\n"
            "        'paddle_tpu_torch.hapi',\n"
            "        'paddle_tpu_torch.hapi.model',\n"
            "        'paddle_tpu_torch.hapi.callbacks',\n"
            "        'paddle_tpu_torch.hapi.model_summary',\n"
            "        'paddle_tpu_torch.vision',\n"
            "        'paddle_tpu_torch.vision.datasets',\n"
            "        'paddle_tpu_torch.vision.transforms',\n"
            "        'paddle_tpu_torch.vision.ops',\n"
            "        'paddle_tpu_torch.jit',\n"
            "        'paddle_tpu_torch.jit.dy2static',\n"
            "        'paddle_tpu_torch.static',\n"
            "        'paddle_tpu_torch.static.ir_pass',\n"
            "        'paddle_tpu_torch.static.nn',\n"
            "        'paddle_tpu_torch.static.extras',\n"
            "        'paddle_tpu_torch.static.amp',\n"
            "        'paddle_tpu_torch.static.sparsity',\n"
            "        'paddle_tpu_torch.onnx',\n"
            "        'paddle_tpu_torch.distributed.passes',\n"
            "        'paddle_tpu_torch.distributed.env',\n"
            "        'paddle_tpu_torch.distributed.collective',\n"
            "        'paddle_tpu_torch.distributed.communication',\n"
            "        'paddle_tpu_torch.distributed.communication.stream',\n"
            "        'paddle_tpu_torch.distributed.comm_extras',\n"
            "        'paddle_tpu_torch.distributed.store',\n"
            "        'paddle_tpu_torch.distributed.launch',\n"
            "        'paddle_tpu_torch.distributed.launch.main',\n"
            "        'paddle_tpu_torch.distributed.launch.__main__',\n"
            "        'paddle_tpu_torch.distributed.fleet',\n"
            "        'paddle_tpu_torch.distributed.fleet.elastic',\n"
            "        'paddle_tpu_torch.distributed.parallel_layers',\n"
            "        'paddle_tpu_torch.distributed.fleet.base.topology',\n"
            "        'paddle_tpu_torch.distributed.fleet.base.distributed_strategy',\n"
            "        'paddle_tpu_torch.distributed.fleet.layers.mp_layers',\n"
            "        'paddle_tpu_torch.distributed.fleet.meta_parallel',\n"
            "        'paddle_tpu_torch.distributed.fleet.meta_parallel.pp_layers',\n"
            "        'paddle_tpu_torch.distributed.fleet.meta_parallel.pp_compiled',\n"
            "        'paddle_tpu_torch.distributed.fleet.meta_optimizers',\n"
            "        'paddle_tpu_torch.distributed.fleet.utils',\n"
            "        'paddle_tpu_torch.distributed.sharding',\n"
            "        'paddle_tpu_torch.distributed.auto_parallel',\n"
            "        'paddle_tpu_torch.incubate',\n"
            "        'paddle_tpu_torch.incubate.autotune',\n"
            "        'paddle_tpu_torch.incubate.distributed',\n"
            "        'paddle_tpu_torch.incubate.distributed.fleet',\n"
            "        'paddle_tpu_torch.incubate.distributed.moe',\n"
            "        'paddle_tpu_torch.incubate.distributed.moe.functional',\n"
            "        'paddle_tpu_torch.incubate.distributed.moe.gate',\n"
            "        'paddle_tpu_torch.incubate.distributed.moe.grad_clip',\n"
            "        'paddle_tpu_torch.incubate.distributed.moe.moe_layer',\n"
            "        'paddle_tpu_torch.vision.models',\n"
            "        'paddle_tpu_torch.vision.models.resnet',\n"
            "        'paddle_tpu_torch.vision.models.vgg',\n"
            "        'paddle_tpu_torch.vision.models.alexnet',\n"
            "        'paddle_tpu_torch.vision.models.lenet',\n"
            "        'paddle_tpu_torch.vision.models.mobilenet',\n"
            "        'paddle_tpu_torch.vision.models.mobilenetv3',\n"
            "        'paddle_tpu_torch.vision.models.squeezenet',\n"
            "        'paddle_tpu_torch.vision.models.densenet',\n"
            "        'paddle_tpu_torch.vision.models.googlenet',\n"
            "        'paddle_tpu_torch.vision.models.shufflenetv2',\n"
            "        'paddle_tpu_torch.vision.models.ppyoloe',\n"
            "        'paddle_tpu_torch.fft',\n"
            "        'paddle_tpu_torch.signal',\n"
            "        'paddle_tpu_torch.audio',\n"
            "        'paddle_tpu_torch.audio.functional',\n"
            "        'paddle_tpu_torch.audio.features',\n"
            "        'paddle_tpu_torch.audio.backends',\n"
            "        'paddle_tpu_torch.audio.datasets',\n"
            "        'paddle_tpu_torch.nn.layer.rnn',\n"
            "        'paddle_tpu_torch.nn.decode',\n"
            "        'paddle_tpu_torch.text.viterbi',\n"
            "        'paddle_tpu_torch.text.datasets',\n"
            "        'paddle_tpu_torch.text.datasets_ref',\n"
            "        'paddle_tpu_torch.text.models.bert',\n"
            "        'paddle_tpu_torch.sparse',\n"
            "        'paddle_tpu_torch.sparse.nn',\n"
            "        'paddle_tpu_torch.sparse.nn.conv',\n"
            "        'paddle_tpu_torch.sparse.nn.functional',\n"
            "        'paddle_tpu_torch.distribution',\n"
            "        'paddle_tpu_torch.distribution.transform',\n"
            "        'paddle_tpu_torch.quantization',\n"
            "        'paddle_tpu_torch.quantization.observers',\n"
            "        'paddle_tpu_torch.geometric',\n"
            "        'paddle_tpu_torch.linalg',\n"
            "        'paddle_tpu_torch.hub',\n"
            "        'paddle_tpu_torch.sysconfig',\n"
            "        'paddle_tpu_torch.version',\n"
            "        'paddle_tpu_torch.utils',\n"
            "        'paddle_tpu_torch.utils.unique_name',\n"
            "        'paddle_tpu_torch.utils.download',\n"
            "        'paddle_tpu_torch.utils.cpp_extension',\n"
            "        'paddle_tpu_torch.utils.cpp_extension.recipe',\n"
            "        'paddle_tpu_torch.incubate.nn',\n"
            "        'paddle_tpu_torch.incubate.nn.functional',\n"
            "        'paddle_tpu_torch.incubate.asp',\n"
            "        'paddle_tpu_torch.incubate.autograd',\n"
            "        'paddle_tpu_torch.incubate.checkpoint',\n"
            "        'paddle_tpu_torch.incubate.optimizer',\n"
            "        'paddle_tpu_torch.incubate.optimizer.wrappers',\n"
            "        'paddle_tpu_torch.incubate.optimizer.functional',\n"
            "        'paddle_tpu_torch.incubate.optimizer.functional.lbfgs',\n"
            "        'paddle_tpu_torch.incubate.operators',\n"
            "        'paddle_tpu_torch.text.models.ernie'} <= set(mods), mods\n"
            "from paddle_tpu_torch.serving import make_engine\n"
            "from paddle_tpu_torch.inference import create_predictor\n"
            "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_default_device_raises_without_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, tm = models
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gpt_tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedGenerationEngine(tm, **ENGINE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GenerationEngine(tm, **ENGINE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpeculativeEngine(tm, **ENGINE)
    eng = PagedGenerationEngine(tm, device="cpu", **ENGINE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Scheduler(eng)
    # the allocators default to the card too
    from paddle_tpu_torch.serving import blocks
    for alloc in (lambda **kw: blocks.alloc_pools(1, 2, 8, 2, 4, **kw),
                  lambda **kw: blocks.alloc_quant_pools(1, 2, 8, 2, 4, **kw),
                  lambda **kw: tkvc.alloc_kv(1, 8, 2, 4, **kw),
                  lambda **kw: tkvc.alloc_cache(1, 1, 8, 2, 4, **kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            alloc()
        assert all(t.device.type == "cpu" for t in
                   torch.utils._pytree.tree_leaves(alloc(device="cpu")))
    assert SpeculativeEngine(tm, device="cpu", **ENGINE).device.type == "cpu"
