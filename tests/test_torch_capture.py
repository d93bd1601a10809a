"""The port's serving executables and the static storage CUDA graphs need.

On the CPU (JAX tiny GPT weights carried into the port with
`load_jax_params`):

  * `executable_names()` equals the JAX engine's for the same
    `PagedEngineConfig` and `SpecDecodeConfig`;
  * `precompile()` reports every executable "eager", captures nothing and
    leaves the token streams as they are;
  * the storage the graphs read keeps its device address (`data_ptr()`)
    across decode steps, speculative rounds, a weight swap, an adoption,
    a prefix restore and a preemption: the packed inputs, the pools and
    their scales, the weights and int8 codes, the draft's dense cache and
    its prefill caches, the verify window;
  * a swap to new weights changes later streams and leaves the module and
    the caller's tensors as they were.

On the card (marker `cuda`; skipped without CUDA, and run there with
`python -m pytest --noconftest -m cuda tests/test_torch_capture.py`;
`chip_smoke.py` runs the same checks at GPT-125M): after serving, a swap,
an adoption and a restore every executable was captured exactly once, the
launch counts hold 2 a forward at the tiny GPT's 2 layers, and a replayed
decode step's logits equal the same forward run eagerly.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.serving import (PagedGenerationEngine, Scheduler,
                                      SpeculativeEngine)
from paddle_tpu_torch.text.models import GPT, GPTConfig, gpt_tiny
from paddle_tpu_torch.text.models.convert import load_jax_params

ENGINE = dict(slots=2, max_len=64, block_size=8)


# The JAX package is imported inside the fixtures and tests that use it,
# so the card's tests run where there is no JAX: `python -m pytest
# --noconftest -m cuda tests/test_torch_capture.py`.
@pytest.fixture(scope="module")
def models():
    import paddle_tpu
    from paddle_tpu.text.models import gpt_tiny as jgpt_tiny
    paddle_tpu.seed(7)
    jm = jgpt_tiny()
    jm.eval()
    params = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, load_jax_params(gpt_tiny(device="cpu"), params)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs capture only on the "
                    "card")
    return "cuda"


def _card_gpt(seed=3):
    """A 2-layer GPT with head_dim 64, the paged kernel's."""
    return GPT(GPTConfig(hidden_size=128, num_layers=2, num_heads=2,
                         vocab_size=1024, max_position_embeddings=256),
               device="cuda", seed=seed)


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 1000, n)


def _serve(eng, prompts, max_new=6, device="cpu"):
    sched = Scheduler(eng, device=device)
    hs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    sched.run_until_idle()
    assert all(h.status == "DONE" for h in hs)
    return [h.tokens for h in hs], sched


@pytest.mark.parametrize("spec", [False, True])
def test_executable_names_equal_jax(models, spec):
    from paddle_tpu.serving import PagedGenerationEngine as JPagedEngine
    from paddle_tpu.serving import SpeculativeEngine as JSpeculativeEngine
    jm, tm = models
    kw = dict(ENGINE, prefill_buckets=(8, 16, 64))
    if spec:
        kw.update(gamma=3, draft_layers=1)
        jax_eng = JSpeculativeEngine(jm, **kw)
        port = SpeculativeEngine(tm, device="cpu", **kw)
    else:
        jax_eng = JPagedEngine(jm, **kw)
        port = PagedGenerationEngine(tm, device="cpu", **kw)
    assert port.executable_names() == jax_eng.executable_names()


def test_precompile_on_cpu_is_eager_and_moves_nothing(models):
    _, tm = models
    prompts = [_prompt(1, 9), _prompt(2, 20), _prompt(3, 5)]
    base, _ = _serve(SpeculativeEngine(tm, device="cpu", gamma=2, **ENGINE),
                     prompts)
    eng = SpeculativeEngine(tm, device="cpu", gamma=2, **ENGINE)
    report = eng.precompile()
    assert report == dict.fromkeys(eng.executable_names(), "eager")
    assert eng.capture_counts == {}
    assert eng._rng_nonce == 0 and not eng._slot_active.any()
    got, _ = _serve(eng, prompts)
    assert got == base
    assert eng.capture_counts == {}


def _pointers(eng):
    """{name: data_ptr} of every tensor the executables read or write."""
    out = {"io": eng._io._dev.data_ptr(),
           "prefill_io": eng._pf._dev.data_ptr()}
    for i, layer in enumerate(eng._pool):
        for field in layer._fields:
            out[f"pool{i}.{field}"] = getattr(layer, field).data_ptr()
    for name, t in eng._params.items():
        out[name] = t.data_ptr()
    for name, v in eng._decode_params.items():
        if isinstance(v, dict):
            out[f"{name}.q"] = v["q"].data_ptr()
            out[f"{name}.scale"] = v["scale"].data_ptr()
    if isinstance(eng, SpeculativeEngine):
        out["window"] = eng._window.data_ptr()
        for name, t in eng._draft_params.items():
            out[f"draft.{name}"] = t.data_ptr()
        for i, layer in enumerate(eng._draft_cache.layers):
            out[f"draft{i}.k"] = layer.k.data_ptr()
            out[f"draft{i}.v"] = layer.v.data_ptr()
        for b, cache in eng._draft_local.items():
            out[f"draft_local[{b}]"] = cache.layers[0].k.data_ptr()
    return out


def test_static_storage_keeps_its_address(models):
    _, tm = models
    kw = dict(ENGINE, gamma=2, kv_dtype="int8", weight_dtype="int8",
              device="cpu")
    eng = SpeculativeEngine(tm, **kw)
    ptrs = _pointers(eng)
    host = {n: a.__array_interface__["data"][0]
            for n, a in (("pos", eng._pos), ("tables", eng._tables),
                         ("tokens", eng._last_tokens),
                         ("draft_pos", eng._draft_pos))}
    # decode steps and speculative rounds
    eng.prefill(0, _prompt(4, 17))
    eng.decode()
    eng.decode_many()
    # a weight swap
    other = gpt_tiny(device="cpu", seed=8)
    eng.swap_params({k: v.detach().clone()
                     for k, v in other.named_parameters()})
    # an adoption and a prefix restore from another engine
    src = PagedGenerationEngine(tm, **{k: v for k, v in kw.items()
                                       if k != "gamma"})
    first = src.prefill(0, _prompt(5, 26))
    ks, vs, plen = src.extract_kv(0)
    eng.adopt_kv(1, ks, vs, plen, first)
    eng.decode_many()
    pks, pvs, n = src.extract_prefix_kv(_prompt(5, 26))
    eng.reset_slot(1)
    assert eng.restore_prefix(_prompt(5, 26), pks, pvs, n) == 24
    # preemption under a tight pool, through the scheduler
    _serve(eng, [_prompt(6 + i, 20) for i in range(3)], max_new=30)
    tight = SpeculativeEngine(tm, num_blocks=8, **kw)
    tight_ptrs = _pointers(tight)
    _, sched = _serve(tight, [_prompt(6 + i, 20) for i in range(3)],
                      max_new=30)
    assert sched.counts["serving.preempted"] >= 1
    assert _pointers(eng) == ptrs
    assert _pointers(tight) == tight_ptrs
    assert {n: a.__array_interface__["data"][0]
            for n, a in (("pos", eng._pos), ("tables", eng._tables),
                         ("tokens", eng._last_tokens),
                         ("draft_pos", eng._draft_pos))} == host
    assert eng._pos.base is not None and eng._tables.base is not None


def test_swap_to_new_weights_changes_streams_not_sources(models):
    _, tm = models
    module_before = {k: v.detach().clone()
                     for k, v in tm.named_parameters()}
    other = gpt_tiny(device="cpu", seed=8)
    new = {k: v.detach().clone() for k, v in other.named_parameters()}
    new_before = {k: v.clone() for k, v in new.items()}
    prompts = [_prompt(7, 12), _prompt(8, 30)]
    kw = dict(ENGINE, enable_prefix_cache=False, device="cpu")
    eng = PagedGenerationEngine(tm, **kw)
    before, _ = _serve(eng, prompts)
    assert eng.swap_params(new) == len(new)
    after, _ = _serve(eng, prompts)
    want, _ = _serve(PagedGenerationEngine(other, **kw), prompts)
    assert after == want and after != before
    for k, v in tm.named_parameters():
        assert torch.equal(v, module_before[k])
    for k, v in new.items():
        assert torch.equal(v, new_before[k])
        assert v.data_ptr() != eng._params[k].data_ptr()


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_each_executable_is_captured_once(card):
    model = _card_gpt()
    from paddle_tpu_torch.ops import paged_attention as pa
    eng = SpeculativeEngine(model, device=card, gamma=2, **ENGINE)
    assert set(eng.precompile().values()) == {"captured"}
    pa.launches = pa.launches_window = pa.launches_prefill = 0
    prompts = [_prompt(9 + i, n) for i, n in enumerate((5, 20, 40))]
    _, sched = _serve(eng, prompts, device=card)
    m = sched.metrics()
    prefills = len(prompts) + m["requests"]["serving.preempted"]
    assert pa.launches == 2 * (m["decode_steps"] + prefills)
    assert pa.launches_window == 2 * m["decode_steps"]
    assert eng.kernel_launches == pa.launches
    eng.swap_params({k: v.detach().clone()
                     for k, v in model.named_parameters()})
    src = PagedGenerationEngine(model, device=card, **ENGINE)
    first = src.prefill(0, _prompt(20, 26))
    ks, vs, plen = src.extract_kv(0)
    eng.adopt_kv(0, ks, vs, plen, first)
    eng.decode_many()
    eng.decode()
    pks, pvs, n = src.extract_prefix_kv(_prompt(20, 26))
    eng.reset_slot(0)
    eng.restore_prefix(_prompt(20, 26), pks, pvs, n)
    eng.prefill(0, _prompt(20, 26))
    assert eng.capture_counts == dict.fromkeys(eng.executable_names(), 1)


@pytest.mark.cuda
def test_replayed_decode_equals_the_eager_forward(card):
    model = _card_gpt()
    eng = PagedGenerationEngine(model, device=card, **ENGINE)
    for s in range(2):
        eng.prefill(s, _prompt(30 + s, 9 + 11 * s))
    eng.ensure_decode_capacity()
    eng._io.upload()
    eng._exe.capture("decode", *eng._executable("decode"))
    eng._io.upload()
    replayed = eng._exe.replay("decode")[0].clone()
    eager = eng._decode_fn()[0]
    torch.testing.assert_close(replayed, eager, rtol=0, atol=1e-6)
