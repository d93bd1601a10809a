"""The port's int8 decode weights, logit capture and weight hot-swap
against the JAX package, on the CPU.

The JAX tiny GPT (hidden 128, 2 layers, 4 heads, vocab 1024) is built from
a fixed seed and its weights carried into the port with
`load_jax_params`. The JAX engines run as `tests/test_quant_serving.py`
runs them (`attention_impl="kernel"`: the Pallas kernel in interpret
mode); the port runs `device="cpu"`. Then:

  * every quantized decode weight's int8 codes equal the JAX engine's
    exactly: transposed for an `nn.Linear` (the port keeps `[out, in]`,
    the JAX model `[in, out]`), per vocab row for the tied `wte`; scales
    equal to rtol 0. `wpe`, LayerNorms and biases stay float, and prefill
    serves the float dict;
  * the int8-weight engine's greedy stream is token-exact against the JAX
    int8-weight engine under the gather and the kernel path, and its
    captured `last_logits` agree within atol 1e-4 (float32; the two
    frameworks sum in other orders);
  * `swap_params`: after a swap to other seeded weights the next decodes'
    tokens and `last_logits` equal the JAX engine's after the same swap,
    and the int8 codes are rebuilt; a missing key or a wrong shape raises
    and the old weights keep serving; the engine stages copies of its own,
    so updating the source tensors in place afterwards changes nothing;
  * `Scheduler.schedule_weight_swap` applies between steps, in arrival
    order, sets each event with its own result and `model_version`;
  * the teacher-forced quality gate of `tools/load_harness.py`
    (`quant_quality`) holds for the port: greedy match >= 0.99 and mean
    logit KL < 1e-3 against the float engine.
Every compared step's top-2 logit gap is asserted to be at least 1e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.serving import PagedGenerationEngine as JPagedEngine
from paddle_tpu.text.models import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.serving import PagedGenerationEngine, Scheduler
from paddle_tpu_torch.serving.engine import _quantize_weight
from paddle_tpu_torch.text.models import gpt_tiny
from paddle_tpu_torch.text.models.convert import load_jax_params

ENGINE = dict(slots=2, max_len=64, block_size=8)
MIN_GAP = 1e-4          # a top-2 logit gap below this is a near-tie
QUANTIZED = ("wte.weight", "blocks.0.attn.qkv.weight",
             "blocks.0.attn.out_proj.weight", "blocks.1.mlp.fc1.weight",
             "blocks.1.mlp.fc2.weight")
FLOAT = ("wpe.weight", "blocks.0.ln1.weight", "blocks.0.attn.qkv.bias",
         "ln_f.bias")


def _jax_params(seed):
    paddle_tpu.seed(seed)
    jm = jgpt_tiny()
    jm.eval()
    return jm, {k: np.asarray(v) for k, v in jm.state_dict().items()}


@pytest.fixture(scope="module")
def models():
    """(JAX tiny GPT, the port's tiny GPT on the CPU with its weights)."""
    jm, params = _jax_params(7)
    return jm, load_jax_params(gpt_tiny(device="cpu"), params)


@pytest.fixture(scope="module")
def other_weights():
    """Other seeded weights: (JAX-layout arrays, the port's tensors)."""
    _, params = _jax_params(8)
    tm = load_jax_params(gpt_tiny(device="cpu"), params)
    return params, {k: v.detach().clone() for k, v in
                    tm.named_parameters()}


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 1000, n)


PROMPTS = [_prompt(20, 9), _prompt(21, 17)]


def _decode(eng, steps, gaps=None):
    """`steps` decodes of both slots -> (tokens [steps][2], logits)."""
    toks, logits = [], []
    for _ in range(steps):
        toks.append([int(t) for t in eng.decode()])
        logits.append(np.asarray(eng.last_logits, np.float32))
        if gaps is not None:
            top = np.sort(logits[-1], axis=-1)[:, -2:]
            gaps.extend((top[:, 1] - top[:, 0]).tolist())
    return toks, logits


def _codes(entry):
    return entry["q"].numpy(), entry["scale"].numpy()


# ------------------------------------------------------------------ codes
def test_int8_codes_equal_jax_codes_transposed(models):
    jm, tm = models
    jeng = JPagedEngine(jm, weight_dtype="int8", **ENGINE)
    teng = PagedGenerationEngine(tm, weight_dtype="int8", device="cpu",
                                 **ENGINE)
    quantized = {n for n, v in teng._decode_params.items()
                 if isinstance(v, dict)}
    assert quantized == {n for n, v in jeng._decode_params.items()
                         if isinstance(v, dict)}
    assert set(QUANTIZED) <= quantized
    for name in quantized:
        jq = np.asarray(jeng._decode_params[name]["q"])
        js = np.asarray(jeng._decode_params[name]["scale"])
        tq, ts = _codes(teng._decode_params[name])
        assert tq.dtype == np.int8
        if name == "wte.weight":                 # per vocab row in both
            np.testing.assert_array_equal(tq, jq)
            np.testing.assert_array_equal(ts, js)
        else:                                    # [out, in] vs [in, out]
            np.testing.assert_array_equal(tq, jq.T)
            np.testing.assert_array_equal(ts, js.T)
        assert ts.shape[0] == tq.shape[0] and ts.shape[1] == 1


def test_non_matmul_params_stay_float_and_prefill_serves_floats(models):
    _, tm = models
    eng = PagedGenerationEngine(tm, weight_dtype="int8", device="cpu",
                                **ENGINE)
    for name in FLOAT:
        assert eng._decode_params[name] is eng._params[name]
    # the serving dict is the module's own tensors, no copy
    for name, p in tm.named_parameters():
        assert eng._params[name] is p
    seen = []
    forward = eng._forward

    def record(ids, cache, params=None):
        seen.append(params)
        return forward(ids, cache, params)
    eng._forward = record
    eng.prefill(0, PROMPTS[0])
    assert seen[-1] is None                      # prefill: `_params`
    eng.decode()
    w = seen[-1]["blocks.0.attn.qkv.weight"]     # decode: dequantized
    q, s = _codes(eng._decode_params["blocks.0.attn.qkv.weight"])
    np.testing.assert_array_equal(w.numpy(),
                                  q.astype(np.float32) * (s / 127.0))
    assert not torch.equal(w, eng._params["blocks.0.attn.qkv.weight"])


# ---------------------------------------------------------------- streams
@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_int8_weight_stream_token_exact_vs_jax(models, impl):
    jm, tm = models
    kw = dict(ENGINE, weight_dtype="int8", capture_logits=True,
              attention_impl=impl)
    jeng = JPagedEngine(jm, **kw)
    teng = PagedGenerationEngine(tm, device="cpu", **kw)
    assert [teng.prefill(s, p) for s, p in enumerate(PROMPTS)] == \
        [jeng.prefill(s, p) for s, p in enumerate(PROMPTS)]
    gaps = []
    got, got_logits = _decode(teng, 8, gaps)
    want, want_logits = _decode(jeng, 8)
    assert got == want
    assert min(gaps) >= MIN_GAP, min(gaps)
    np.testing.assert_allclose(np.stack(got_logits), np.stack(want_logits),
                               atol=1e-4, rtol=0)


def test_last_logits_match_jax(models):
    """Float weights: the captured [slots, vocab] logits of every decode
    step agree with the JAX engine's."""
    jm, tm = models
    kw = dict(ENGINE, capture_logits=True)
    jeng = JPagedEngine(jm, attention_impl="gather", **kw)
    teng = PagedGenerationEngine(tm, device="cpu", **kw)
    assert teng.last_logits is None
    for s, p in enumerate(PROMPTS):
        teng.prefill(s, p)
        jeng.prefill(s, p)
    got, got_logits = _decode(teng, 4)
    want, want_logits = _decode(jeng, 4)
    assert got == want
    assert got_logits[0].shape == (2, tm.cfg.vocab_size)
    np.testing.assert_allclose(np.stack(got_logits), np.stack(want_logits),
                               atol=1e-4, rtol=0)


# ------------------------------------------------------------------- swaps
def test_swap_params_matches_jax_after_the_same_swap(models, other_weights):
    jm, tm = models
    jparams, tparams = other_weights
    kw = dict(ENGINE, weight_dtype="int8", capture_logits=True,
              attention_impl="gather")
    jeng = JPagedEngine(jm, **kw)
    teng = PagedGenerationEngine(tm, device="cpu", **kw)
    for s, p in enumerate(PROMPTS):
        assert teng.prefill(s, p) == jeng.prefill(s, p)
    assert _decode(teng, 2)[0] == _decode(jeng, 2)[0]
    old_codes = teng._decode_params["blocks.0.mlp.fc1.weight"]["q"]
    assert teng.swap_params(tparams) == len(tparams)
    assert jeng.swap_params(jparams) == len(jparams)
    gaps = []
    got, got_logits = _decode(teng, 4, gaps)
    want, want_logits = _decode(jeng, 4)
    assert got == want
    assert min(gaps) >= MIN_GAP, min(gaps)
    np.testing.assert_allclose(np.stack(got_logits), np.stack(want_logits),
                               atol=1e-4, rtol=0)
    # the int8 decode set was rebuilt from the new weights
    new_codes, _ = _quantize_weight(tparams["blocks.0.mlp.fc1.weight"])
    assert torch.equal(teng._decode_params["blocks.0.mlp.fc1.weight"]["q"],
                       new_codes)
    assert not torch.equal(old_codes, new_codes)
    # the module is untouched
    assert dict(tm.named_parameters())["wte.weight"] is not \
        teng._params["wte.weight"]


def test_swap_params_refuses_bad_dicts_and_keeps_serving(models,
                                                         other_weights):
    _, tm = models
    _, tparams = other_weights
    eng = PagedGenerationEngine(tm, weight_dtype="int8", device="cpu",
                                **ENGINE)
    ref = PagedGenerationEngine(tm, weight_dtype="int8", device="cpu",
                                **ENGINE)
    params, decode_params = eng._params, eng._decode_params
    missing = dict(tparams)
    del missing["blocks.1.mlp.fc2.bias"]
    with pytest.raises(ValueError, match="missing"):
        eng.swap_params(missing)
    wrong = dict(tparams)
    wrong["blocks.0.attn.qkv.weight"] = torch.zeros((3, 3))
    with pytest.raises(ValueError, match="shape"):
        eng.swap_params(wrong)
    assert eng._params is params and eng._decode_params is decode_params
    for e in (eng, ref):
        e.prefill(0, PROMPTS[0])
    assert [int(eng.decode()[0]) for _ in range(4)] == \
        [int(ref.decode()[0]) for _ in range(4)]


def test_swap_params_keeps_its_own_copy(models, other_weights):
    """The swapped-in tensors stay the caller's: updating them in place
    afterwards (a trainer stepping the model it swapped in) changes neither
    the next decodes' tokens and `last_logits` nor the int8 codes, which
    keep agreeing with the staged float weights. The reference stages
    immutable arrays, so its swaps cannot be changed afterwards either."""
    _, tm = models
    _, tparams = other_weights
    kw = dict(ENGINE, weight_dtype="int8", capture_logits=True,
              attention_impl="gather", device="cpu")
    eng = PagedGenerationEngine(tm, **kw)
    ref = PagedGenerationEngine(tm, **kw)
    src = {k: v.clone() for k, v in tparams.items()}
    eng.swap_params(src)
    ref.swap_params({k: v.clone() for k, v in tparams.items()})
    with torch.no_grad():
        for v in src.values():
            v.add_(1.0)
    for name, t in eng._params.items():
        assert t.data_ptr() != src[name].data_ptr()
        assert torch.equal(t, tparams[name])
    for e in (eng, ref):
        for s, p in enumerate(PROMPTS):
            e.prefill(s, p)
    got, got_logits = _decode(eng, 4)
    want, want_logits = _decode(ref, 4)
    assert got == want
    np.testing.assert_array_equal(np.stack(got_logits),
                                  np.stack(want_logits))
    for name in QUANTIZED:
        codes, _ = _quantize_weight(eng._params[name])
        assert torch.equal(eng._decode_params[name]["q"], codes)


def test_swap_casts_to_the_serving_dtype(models, other_weights):
    _, tm = models
    _, tparams = other_weights
    eng = PagedGenerationEngine(tm, device="cpu", **ENGINE)
    wide = {k: v.double().numpy() for k, v in tparams.items()}
    eng.swap_params(wide)
    assert all(v.dtype == torch.float32 for v in eng._params.values())
    assert torch.equal(eng._params["wte.weight"], tparams["wte.weight"])


def _serve_with_swaps(tm, prompts, swaps_at):
    """Serve `prompts` for 8 tokens each; `swaps_at` maps a step number to
    a list of (params, version) to schedule before it. Returns (streams,
    scheduler, events)."""
    eng = PagedGenerationEngine(tm, device="cpu", **ENGINE)
    sched = Scheduler(eng, device="cpu")
    hs = [sched.submit(p, max_new_tokens=8) for p in prompts]
    events = []
    while True:
        for params, version in swaps_at.get(sched._steps, ()):
            events.append(sched.schedule_weight_swap(params, version))
        if not sched.step():
            break
    assert all(h.status == "DONE" for h in hs)
    return [h.tokens for h in hs], sched, events


def test_scheduler_weight_swap_between_steps_in_order(models):
    _, tm = models
    base, _, _ = _serve_with_swaps(tm, PROMPTS, {})
    clone = {k: v.detach().clone() for k, v in tm.named_parameters()}
    bad = dict(clone)
    bad["wpe.weight"] = torch.zeros((2, 2))
    got, sched, events = _serve_with_swaps(
        tm, PROMPTS, {2: [(clone, 1)], 4: [(bad, 2), (clone, 3)]})
    assert got == base                    # a clone changes no token
    assert all(ev.is_set() for ev in events)
    results = [ev.swap_result for ev in events]
    assert [r["ok"] for r in results] == [True, False, True]
    assert [r["version"] for r in results] == [1, 2, 3]
    assert "shape" in results[1]["error"]
    assert results[0]["params"] == len(clone)
    assert sched.model_version == 3 and sched.last_swap == results[2]
    assert sched.apply_pending_swap() is False


# ---------------------------------------------------------- quality gate
def test_teacher_forced_int8_quality_gate(models):
    """`tools/load_harness.py:quant_quality` on the port: both engines are
    fed the float engine's token each step (`set_slot_token`), and the
    int8-weight, int8-KV engine's choices and logits are held to the
    float engine's."""
    _, tm = models
    kw = dict(slots=3, max_len=64, block_size=8, capture_logits=True,
              device="cpu")
    oracle = PagedGenerationEngine(tm, **kw)
    quant = PagedGenerationEngine(tm, kv_dtype="int8", weight_dtype="int8",
                                  **kw)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 1000, int(rng.randint(8, 20)))
               for _ in range(3)]
    for s, p in enumerate(prompts):
        quant.prefill(s, p)
        quant.set_slot_token(s, oracle.prefill(s, p))
    matches, kls = [], []
    for _ in range(12):
        toks = oracle.decode()
        quant.decode()
        lo = oracle.last_logits.astype(np.float64)
        lq = quant.last_logits.astype(np.float64)
        matches.extend(lo.argmax(-1) == lq.argmax(-1))
        po = np.exp(lo - lo.max(-1, keepdims=True))
        po /= po.sum(-1, keepdims=True)
        zq = lq - lq.max(-1, keepdims=True)
        log_q = zq - np.log(np.exp(zq).sum(-1, keepdims=True))
        kls.extend((po * (np.log(po + 1e-30) - log_q)).sum(-1))
        for s in range(3):
            quant.set_slot_token(s, int(toks[s]))
    assert np.mean(matches) >= 0.99, np.mean(matches)
    assert np.mean(kls) < 1e-3, np.mean(kls)
