"""The port's speculative decode and `GPTForGeneration` against the JAX
package, on the CPU.

The JAX tiny GPT (hidden 128, 2 layers, 4 heads, vocab 1024) is built from
a fixed seed and its weights carried into the port with
`load_jax_params`. The JAX engines run as `tests/test_spec_decode.py` runs
them (`attention_impl="kernel"`: the Pallas kernel in interpret mode); the
port runs `device="cpu"`, where the paged-attention wrapper takes its plain
version. Then:

  * `sampling.greedy_verify` equals the JAX rule exactly on seeded logits
    (full accept, first reject, mid reject);
  * speculative greedy streams are token-exact against the JAX
    `SpeculativeEngine` and against the port's one-token paged engine, for
    gamma 1, 3 and 5 under the gather and the kernel path; with a draft of
    its own weights; with 2-token blocks that a 6-token window crosses;
    through the scheduler with forced preemption; with an eos inside an
    accepted window;
  * int8 KV pools and int8 decode weights compose with speculative decode
    (at least 0.9 agreement with the one-token int8 engine, the JAX bar);
  * a weight swap re-points the truncated draft's shared tensors, and
    updating the source tensors in place after it changes nothing;
  * `GPTForGeneration.generate` equals the JAX one, with and without the
    cache, with eos.
Every compared one-token step's top-2 logit gap is asserted to be at least
1e-4, so no comparison sits on a near-tie.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu
from paddle_tpu.serving import SpeculativeEngine as JSpeculativeEngine
from paddle_tpu.serving import sampling as jsampling
from paddle_tpu.text.models import GPTForGeneration as JGPTForGeneration
from paddle_tpu.text.models import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.serving import (PagedGenerationEngine, Scheduler,
                                      SpecDecodeConfig, SpeculativeEngine,
                                      sampling, truncated_draft)
from paddle_tpu_torch.text.models import GPT, GPTConfig, GPTForGeneration
from paddle_tpu_torch.text.models import gpt_tiny
from paddle_tpu_torch.text.models.convert import load_jax_params

ENGINE = dict(slots=2, max_len=64, block_size=8)
MIN_GAP = 1e-4          # a top-2 logit gap below this is a near-tie
STREAM = 12             # tokens compared per slot


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


PROMPTS = [_prompt(0, 9), _prompt(1, 17)]


def _spec_stream(engine, prompts, n_tokens):
    rows = [[engine.prefill(s, p)] for s, p in enumerate(prompts)]
    while min(len(r) for r in rows) < n_tokens:
        toks, n_emit = engine.decode_many()
        for s in range(len(prompts)):
            rows[s].extend(int(t) for t in toks[s, :int(n_emit[s])])
    return [r[:n_tokens] for r in rows]


def _one_token_stream(engine, prompts, n_tokens, gaps=None):
    """The one-token loop; `gaps` collects the top-2 logit gap of every
    decode step (the engine must capture logits)."""
    rows = [[engine.prefill(s, p)] for s, p in enumerate(prompts)]
    for _ in range(n_tokens - 1):
        out = engine.decode()
        if gaps is not None:
            top = np.sort(engine.last_logits, axis=-1)[:, -2:]
            gaps.extend((top[:, 1] - top[:, 0]).tolist())
        for s in range(len(prompts)):
            rows[s].append(int(out[s]))
    return rows


def _generate(model, prompt, max_new, eos=None):
    out, lengths = GPTForGeneration(model).generate(
        torch.from_numpy(np.asarray(prompt)[None].astype(np.int64)),
        max_new_tokens=max_new, eos_token_id=eos)
    return out[0, :int(lengths[0])].tolist()


@pytest.fixture(scope="module")
def one_token(models):
    """The port's one-token paged stream over PROMPTS, with no near-tie."""
    _, tm = models
    eng = PagedGenerationEngine(tm, device="cpu", capture_logits=True,
                                **ENGINE)
    gaps = []
    rows = _one_token_stream(eng, PROMPTS, STREAM, gaps)
    assert min(gaps) >= MIN_GAP, min(gaps)
    return rows


# ------------------------------------------------------------- verify rule
def _verify_case(kind):
    """Seeded logits [3, 4, 10] and a window whose drafts are accepted in
    full, rejected at the first draft, or rejected in the middle."""
    rng = np.random.RandomState({"full": 1, "first": 2, "mid": 3}[kind])
    logits = rng.randn(3, 4, 10).astype(np.float32)
    choices = logits.argmax(-1)
    window = np.zeros((3, 4), np.int32)
    window[:, 0] = rng.randint(0, 10, 3)
    window[:, 1:] = choices[:, :-1]
    if kind == "first":
        window[:, 1] = (choices[:, 0] + 1) % 10
    elif kind == "mid":
        window[:, 3] = (choices[:, 2] + 1) % 10
    return logits, window


@pytest.mark.parametrize("kind", ["full", "first", "mid"])
def test_greedy_verify_matches_jax(kind):
    logits, window = _verify_case(kind)
    want = [np.asarray(x) for x in jsampling.greedy_verify(
        jnp.asarray(logits), jnp.asarray(window))]
    got = [x.numpy() for x in sampling.greedy_verify(
        torch.from_numpy(logits), torch.from_numpy(window))]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.int32
    n_acc = {"full": 3, "first": 0, "mid": 2}[kind]
    assert got[1].tolist() == [n_acc] * 3


# ------------------------------------------------------------------ streams
@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_spec_stream_token_exact_vs_jax_and_one_token(models, one_token,
                                                      gamma, impl):
    jm, tm = models
    jspec = JSpeculativeEngine(jm, gamma=gamma, draft_layers=1,
                               attention_impl=impl, **ENGINE)
    tspec = SpeculativeEngine(tm, gamma=gamma, draft_layers=1,
                              attention_impl=impl, device="cpu", **ENGINE)
    got = _spec_stream(tspec, PROMPTS, STREAM)
    assert got == _spec_stream(jspec, PROMPTS, STREAM)
    assert got == one_token
    assert tspec.decode_write_tokens == gamma + 1
    assert set(tspec.last_spec_stats) >= {"draft_s", "verify_s"}


def test_spec_with_distinct_draft_model(models, one_token):
    """A draft with its own random weights: the stream is unchanged, only
    the acceptance rate may fall."""
    _, tm = models
    draft = GPT(dataclasses.replace(tm.cfg, num_layers=1), device="cpu",
                seed=11)
    spec = SpeculativeEngine(tm, gamma=4, draft=draft, device="cpu",
                             **ENGINE)
    assert _spec_stream(spec, PROMPTS, STREAM) == one_token


def test_truncated_draft_shares_storage(models):
    _, tm = models
    draft = truncated_draft(tm, 1)
    assert draft.cfg.num_layers == 1
    for name in ("wte.weight", "blocks.0.attn.qkv.weight", "ln_f.bias"):
        d = dict(draft.named_parameters())[name]
        t = dict(tm.named_parameters())[name]
        assert d.data_ptr() == t.data_ptr()
    with pytest.raises(ValueError, match="draft_layers"):
        truncated_draft(tm, 99)


def test_spec_config_validation(models):
    _, tm = models
    with pytest.raises(ValueError, match="greedy"):
        SpecDecodeConfig(decode_strategy="sampling")
    with pytest.raises(ValueError, match="gamma"):
        SpecDecodeConfig(gamma=0)
    with pytest.raises(ValueError, match="capture_logits"):
        SpecDecodeConfig(capture_logits=True)
    alien = GPT(GPTConfig(hidden_size=64, num_layers=1, num_heads=2,
                          vocab_size=77, max_position_embeddings=64),
                device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeEngine(tm, slots=1, max_len=32, draft=alien,
                          device="cpu")


def test_verify_window_grows_blocks_lazily(models):
    """A 6-token window over 2-token blocks crosses several block edges in
    one round: the scheduler-facing growth provisions them all first."""
    _, tm = models
    spec = SpeculativeEngine(tm, slots=1, max_len=64, block_size=2, gamma=5,
                             device="cpu")
    assert spec.decode_write_tokens == 6
    rows = _spec_stream(spec, [_prompt(5, 3)], 14)
    assert rows[0] == _generate(tm, _prompt(5, 3), 14)


# ---------------------------------------------------------------- scheduler
def test_scheduler_spec_streams_exact_with_preemption(models):
    """An oversubscribed pool preempts mid-stream: every request still
    ends DONE with its exact greedy stream, and no block leaks."""
    _, tm = models
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 1000, 6) for _ in range(4)]
    eng = SpeculativeEngine(tm, slots=3, max_len=32, block_size=4,
                            num_blocks=8, enable_prefix_cache=False,
                            gamma=3, device="cpu")
    sched = Scheduler(eng, device="cpu", max_queue=16)
    hs = [sched.submit(p, max_new_tokens=6) for p in prompts]
    sched.run_until_idle()
    assert sched.counts["serving.preempted"] > 0
    for h, p in zip(hs, prompts):
        assert h.status == "DONE"
        assert h.tokens == _generate(tm, p, 6)
        assert h.spec_proposed > 0
        assert 0 <= h.spec_accepted <= h.spec_proposed
    m = sched.metrics()
    assert m["spec_proposed"] == sum(h.spec_proposed for h in hs)
    assert m["spec_acceptance_rate"] == m["spec_accepted"] \
        / m["spec_proposed"]
    assert eng.block_pool.in_use == 0


def test_eos_inside_accepted_window_truncates_exactly(models):
    _, tm = models
    prompt = _prompt(7, 6)
    base = _generate(tm, prompt, 8)
    eos = base[3]                    # the fourth token becomes eos
    want = _generate(tm, prompt, 8, eos=eos)
    assert len(want) < len(base)
    eng = SpeculativeEngine(tm, slots=1, max_len=64, block_size=8, gamma=4,
                            eos_token_id=eos, device="cpu")
    sched = Scheduler(eng, device="cpu", max_queue=4)
    h = sched.submit(prompt, max_new_tokens=8)
    sched.run_until_idle()
    assert h.status == "DONE"
    assert h.tokens == want


# ----------------------------------------------------------- int8 and swaps
def test_spec_int8_kv_and_weights_agree_with_one_token_int8(models):
    """Spec with int8 pools and int8 decode weights against the one-token
    int8 engine: the window writes requantize blocks on another schedule,
    so the streams need only agree on 0.9 of the first 8 tokens (the JAX
    bar). The draft's shared tensors reuse the target's codes."""
    _, tm = models
    kw = dict(slots=3, max_len=64, block_size=8, kv_dtype="int8",
              weight_dtype="int8", device="cpu")
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 1000, int(rng.randint(6, 20)))
               for _ in range(3)]
    base = _one_token_stream(PagedGenerationEngine(tm, **kw), prompts, 9)
    spec = SpeculativeEngine(tm, gamma=2, **kw)
    got = _spec_stream(spec, prompts, 9)
    assert [r[0] for r in got] == [r[0] for r in base]
    agree = np.mean([a == b for g, w in zip(got, base)
                     for a, b in zip(g[1:], w[1:])])
    assert agree >= 0.9, (agree, got, base)
    name = "blocks.0.attn.qkv.weight"
    assert spec._draft_decode_params[name] is spec._decode_params[name]
    assert spec._draft_decode_params[name]["q"].dtype == torch.int8


def test_spec_swap_params_repoints_the_draft(models):
    """After a swap to other weights the truncated draft shares the new
    tensors, and the spec stream is the one-token stream of the new
    weights."""
    _, tm = models
    other = gpt_tiny(device="cpu", seed=8)
    new = {k: v.detach().clone() for k, v in other.named_parameters()}
    # the prefix cache would hand the second prefill blocks written under
    # the old weights (kept across a swap, as in the JAX engine)
    kw = dict(ENGINE, enable_prefix_cache=False, device="cpu")
    spec = SpeculativeEngine(tm, gamma=3, **kw)
    spec.prefill(0, PROMPTS[0])
    spec.decode_many()
    assert spec.swap_params(new) == len(new)
    for name, t in spec._draft_params.items():
        assert t is spec._params[name]
        assert t.data_ptr() != new[name].data_ptr()    # staged copies
        assert torch.equal(t, new[name])
    spec.reset_slot(0)
    got = _spec_stream(spec, PROMPTS, STREAM)
    want = _one_token_stream(PagedGenerationEngine(other, **kw), PROMPTS,
                             STREAM)
    assert got == want
    # the module itself is untouched
    assert dict(tm.named_parameters())["wte.weight"] is not new["wte.weight"]


def test_spec_swap_holds_when_the_source_changes_after(models):
    """Updating the swapped-in tensors in place after the swap changes
    neither the target nor the draft, which still shares the target's new
    tensors: the stream stays the one-token stream of the swapped
    weights."""
    _, tm = models
    other = gpt_tiny(device="cpu", seed=8)
    new = {k: v.detach().clone() for k, v in other.named_parameters()}
    kw = dict(ENGINE, enable_prefix_cache=False, device="cpu")
    spec = SpeculativeEngine(tm, gamma=3, **kw)
    assert spec.swap_params(new) == len(new)
    with torch.no_grad():
        for v in new.values():
            v.mul_(-1.0)
    shared = [n for n, t in spec._draft_params.items()
              if t is spec._params[n]]
    assert shared and len(shared) == len(spec._draft_params)
    got = _spec_stream(spec, PROMPTS, STREAM)
    want = _one_token_stream(PagedGenerationEngine(other, **kw), PROMPTS,
                             STREAM)
    assert got == want


# ------------------------------------------------------------- generation
@pytest.mark.parametrize("use_cache,eos", [(True, None), (False, None),
                                           (True, "third")])
def test_generate_matches_jax(models, use_cache, eos):
    jm, tm = models
    ids = np.random.RandomState(3).randint(0, 1000, (2, 9)).astype(np.int64)
    max_new = 6 if use_cache else 3
    if eos == "third":
        out, _ = GPTForGeneration(tm).generate(torch.from_numpy(ids),
                                               max_new_tokens=max_new)
        eos = int(out[0, 2])
    want, want_len = JGPTForGeneration(jm).generate(
        paddle_tpu.to_tensor(ids), max_new_tokens=max_new, eos_token_id=eos,
        use_cache=use_cache)
    got, got_len = GPTForGeneration(tm).generate(
        torch.from_numpy(ids), max_new_tokens=max_new, eos_token_id=eos,
        use_cache=use_cache)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got_len.numpy(), want_len.numpy())
    assert got.dtype == got_len.dtype == torch.int32
    with pytest.raises(ValueError, match="max_position_embeddings"):
        GPTForGeneration(tm).generate(torch.from_numpy(ids),
                                      max_new_tokens=tm.cfg.
                                      max_position_embeddings)
