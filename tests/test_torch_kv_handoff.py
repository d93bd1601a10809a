"""The port's single-card KV handoff against the JAX package, on the CPU.

The JAX tiny GPT (hidden 128, 2 layers, 4 heads, vocab 1024) is built from
a fixed seed and its weights are carried into the port with
`load_jax_params`; the JAX engines run the gather path, the port its
default kernel path (the kernel's plain version on the CPU). Then:

  * wire: a KV bundle the port packs is byte for byte the JAX package's
    from the same arrays and meta, in v1 (float32), v2 (int8 codes with
    per-block scales) and v3 (with the sampler's rng, in either layout);
    each package unpacks the other's to equal arrays; the port's
    `KVWireError` answers truncation, a padded frame, a foreign magic, a
    shape lie and a scale-count lie, as `tests/test_serving_dist.py` and
    `tests/test_quant_serving.py` hold the reference to;
  * engines: one package prefills and extracts, the bundle crosses the
    wire, the other package adopts and decodes; the stream equals a local
    prefill's, token for token, in both directions and with float32 and
    int8 pools (every port step's top-2 logit gap is asserted to be at
    least 1e-4, so no comparison sits on a near-tie). A sampled stream
    handed from one port engine to another with its v3 rng continues as
    one engine would (sampled bits are a contract inside the port);
  * prefix restore: a chain `extract_prefix_kv` exports from one package
    `restore_prefix` registers in the other; the next prefill hits the
    restored tokens and keeps the local stream; an int8 restore writes
    the JAX restore's codes and scales bit for bit;
  * scheduler: a staged bundle is adopted, a bad one (wrong layer count)
    and a preempted one recompute, and a staged prefix is restored, all
    with the oracle's streams.
"""
import json
import struct

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.serving import PagedGenerationEngine as JPagedEngine
from paddle_tpu.serving.distributed import kv_handoff as jkvh
from paddle_tpu.text.models import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.serving import (BlockAllocError,
                                      PagedGenerationEngine, Scheduler)
from paddle_tpu_torch.serving import prefix_cache as tprefix
from paddle_tpu_torch.serving.distributed import kv_handoff as tkvh
from paddle_tpu_torch.text.models import gpt_tiny
from paddle_tpu_torch.text.models.convert import load_jax_params

ENGINE = dict(slots=2, max_len=64, block_size=8)
MIN_GAP = 1e-4          # a top-2 logit gap below this is a near-tie
STEPS = 6               # decode steps compared after the first token
PACKAGES = {"jax": jkvh, "port": tkvh}


@pytest.fixture(scope="module")
def models():
    """(JAX tiny GPT, the port's tiny GPT on the CPU with its weights)."""
    paddle_tpu.seed(7)
    jm = jgpt_tiny()
    jm.eval()
    params = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, load_jax_params(gpt_tiny(device="cpu"), params)


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 1000, n)


def _engine(pkg, models, **kw):
    jm, tm = models
    if pkg == "jax":
        return JPagedEngine(jm, attention_impl="gather", **ENGINE, **kw)
    return PagedGenerationEngine(tm, device="cpu", **ENGINE, **kw)


def _gap_guard(eng, gaps):
    """Record the top-2 logit gap of every row a port engine picks from."""
    sel, sel_slots = eng._select, eng._select_slots

    def gap(logits):
        top = torch.topk(logits.float(), 2, dim=-1).values
        return (top[..., 0] - top[..., 1]).reshape(-1).tolist()

    def rec_select(logits, slot):
        gaps.extend(gap(logits))
        return sel(logits, slot)

    def rec_slots(logits, picks=None):
        gaps.extend(gap(logits)[:1])            # slot 0 carries the request
        return sel_slots(logits, picks)
    eng._select, eng._select_slots = rec_select, rec_slots
    return eng


def _decode(eng, first, steps=STEPS):
    stream = [int(first)]
    for _ in range(steps):
        eng.ensure_decode_capacity()
        stream.append(int(eng.decode()[0]))
    return stream


# ------------------------------------------------------------------- wire
def _bundle_inputs(kind):
    rng = np.random.RandomState({"v1": 0, "v2": 1, "v3": 2,
                                 "v3_int8": 3}[kind])
    L, T, H, D, sb = 3, 9, 4, 8, 4
    meta = {"first_token": 7, "plen": T, "key": "r1"}
    kw = {}
    if kind in ("v2", "v3_int8"):
        ks = [rng.randint(-127, 128, (T, H, D)).astype(np.int8)
              for _ in range(L)]
        vs = [rng.randint(-127, 128, (T, H, D)).astype(np.int8)
              for _ in range(L)]
        nsb = -(-T // sb)
        kw = dict(k_scales=[rng.rand(nsb, H).astype(np.float32) + .1
                            for _ in range(L)],
                  v_scales=[rng.rand(nsb, H).astype(np.float32) + .1
                            for _ in range(L)],
                  scale_block=sb)
    else:
        ks = [rng.randn(T, H, D).astype(np.float32) for _ in range(L)]
        vs = [rng.randn(T, H, D).astype(np.float32) for _ in range(L)]
    if kind.startswith("v3"):
        kw["rng"] = (1234567, 1)
    return ks, vs, meta, kw


@pytest.mark.parametrize("kind", ["v1", "v2", "v3", "v3_int8"])
def test_bundles_byte_equal_and_cross_unpack(kind):
    ks, vs, meta, kw = _bundle_inputs(kind)
    port = tkvh.pack_kv_bundle(ks, vs, meta=meta, **kw)
    ref = jkvh.pack_kv_bundle(ks, vs, meta=meta, **kw)
    assert isinstance(port, bytes) and port == ref
    version = struct.unpack_from("<II", port, 0)
    head = json.loads(port[8:8 + version[1]])
    assert head["v"] == {"v1": 1, "v2": 2, "v3": 3, "v3_int8": 3}[kind]
    for unpack, bundle in ((tkvh.unpack_kv_bundle, ref),
                           (jkvh.unpack_kv_bundle, port)):
        k2, v2, m2 = unpack(bundle)
        want_k, want_v, want_m = jkvh.unpack_kv_bundle(ref)
        assert m2 == want_m
        for a, b in zip(k2 + v2, want_k + want_v):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, np.asarray(b))
    if kind == "v1":
        np.testing.assert_array_equal(tkvh.unpack_kv_bundle(ref)[0][1],
                                      ks[1])


def test_wire_rejects_truncation_and_lies():
    ks = [np.ones((4, 2, 8), np.float32)] * 2
    buf = tkvh.pack_kv_bundle(ks, ks)
    for cut in (2, 6, len(buf) // 2, len(buf) - 1):
        with pytest.raises(tkvh.KVWireError):
            tkvh.unpack_kv_bundle(buf[:cut])
    with pytest.raises(tkvh.KVWireError):
        tkvh.unpack_kv_bundle(buf + b"\x00")            # padded is a lie
    with pytest.raises(tkvh.KVWireError):
        tkvh.unpack_kv_bundle(b"\xff" * len(buf))       # foreign magic
    with pytest.raises(tkvh.KVWireError):               # shapes disagree
        tkvh.pack_kv_bundle([np.ones((4, 2, 8), np.float32)],
                            [np.ones((3, 2, 8), np.float32)])
    with pytest.raises(tkvh.KVWireError, match="int8"):  # scale-less codes
        tkvh.pack_kv_bundle([np.ones((4, 2, 8), np.int8)] * 2,
                            [np.ones((4, 2, 8), np.int8)] * 2)
    # a header whose scale rows cannot tile its tokens
    q, _, _, kw = _bundle_inputs("v2")
    good = tkvh.pack_kv_bundle(q, q, **kw)
    hlen = struct.unpack_from("<II", good, 0)[1]
    head = json.loads(good[8:8 + hlen])
    head["scale_blocks"] += 1
    blob = json.dumps(head).encode()
    with pytest.raises(tkvh.KVWireError, match="scale count"):
        tkvh.unpack_kv_bundle(struct.pack("<II", 0x3142564B, len(blob))
                              + blob + good[8 + hlen:])
    # the control-verb framing
    payload = tkvh.pack_payload({"key": "r1", "n": 3}, tail=good)
    assert payload == jkvh.pack_payload({"key": "r1", "n": 3}, tail=good)
    obj, tail = tkvh.unpack_payload(payload)
    assert obj == {"key": "r1", "n": 3} and tail == good
    with pytest.raises(tkvh.KVWireError):
        tkvh.unpack_payload(payload[:6])


# ----------------------------------------------------------------- engines
def _ship(src_pkg, src, dst_pkg):
    """Extract slot 0 of `src` in wire form, pack it with the sender's
    package and unpack it with the receiver's; returns (ks, vs, meta)."""
    wire = src.extract_kv_wire(0)
    quant = {k: wire[k] for k in ("k_scales", "v_scales", "scale_block")
             if k in wire}
    bundle = PACKAGES[src_pkg].pack_kv_bundle(
        wire["ks"], wire["vs"], meta={"plen": wire["plen"]}, **quant)
    return PACKAGES[dst_pkg].unpack_kv_bundle(bundle)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("src_pkg,dst_pkg", [("jax", "port"),
                                             ("port", "jax")])
def test_adopted_stream_equals_local_prefill(models, src_pkg, dst_pkg,
                                             kv_dtype):
    prompt = _prompt(3, 19)
    gaps = []
    local_port = _gap_guard(_engine("port", models, kv_dtype=kv_dtype),
                            gaps)
    want = _decode(local_port, local_port.prefill(0, prompt))
    assert min(gaps) >= MIN_GAP, min(gaps)
    local_jax = _engine("jax", models, kv_dtype=kv_dtype)
    assert _decode(local_jax, local_jax.prefill(0, prompt)) == want

    src = _engine(src_pkg, models, kv_dtype=kv_dtype)
    first = src.prefill(0, prompt)
    ks, vs, meta = _ship(src_pkg, src, dst_pkg)
    assert meta["plen"] == len(prompt)
    assert meta.get("quantized", False) == (kv_dtype == "int8")
    dst = _engine(dst_pkg, models, kv_dtype=kv_dtype)
    dst.prefill(1, _prompt(4, 5))        # another request stays resident
    assert dst.adopt_kv(0, ks, vs, meta["plen"], first) == first
    assert dst.last_prefill_stats["adopted"] is True
    assert int(dst.slot_positions()[0]) == len(prompt)
    assert _decode(dst, first) == want


def test_adopt_validates_and_frees_on_failure(models):
    eng = _engine("port", models)
    src = _engine("port", models)
    first = src.prefill(0, _prompt(5, 12))
    ks, vs, plen = src.extract_kv(0)
    free = eng.block_pool.available
    with pytest.raises(ValueError, match="layers"):
        eng.adopt_kv(0, ks[:1], vs[:1], plen, first)
    with pytest.raises(ValueError, match="shape"):
        eng.adopt_kv(0, [k[:-1] for k in ks], vs, plen, first)
    with pytest.raises(ValueError, match="limits"):
        eng.adopt_kv(0, [np.zeros((64, 4, 32), np.float32)] * 2,
                     [np.zeros((64, 4, 32), np.float32)] * 2, 64, first)
    assert eng.block_pool.available == free
    tight = _engine("port", models, num_blocks=2)
    with pytest.raises(BlockAllocError):
        tight.adopt_kv(0, ks, vs, plen, first)
    assert tight.block_pool.available == 1
    assert not tight._slot_active[0]


def test_v3_rng_continues_a_sampled_stream(models):
    kw = dict(decode_strategy="sampling", temperature=0.8, top_k=20)
    prompt = _prompt(6, 13)
    one = _engine("port", models, **kw)
    want = _decode(one, one.prefill(0, prompt, rng=(424242, 0)))
    a = _engine("port", models, **kw)
    first = a.prefill(0, prompt, rng=(424242, 0))
    wire = a.extract_kv_wire(0)
    ks, vs, meta = tkvh.unpack_kv_bundle(tkvh.pack_kv_bundle(
        wire["ks"], wire["vs"], meta={"plen": wire["plen"],
                                      "first_token": first},
        rng=(424242, 1)))
    b = _engine("port", models, **kw)
    b.adopt_kv(0, ks, vs, meta["plen"], meta["first_token"],
               rng=meta["rng"])
    assert _decode(b, first) == want
    # without the rng the slot samples from a fresh seed
    c = _engine("port", models, **kw)
    c.adopt_kv(0, ks, vs, meta["plen"], first)
    assert _decode(c, first) != want


# ---------------------------------------------------------- prefix restore
@pytest.mark.parametrize("src_pkg,dst_pkg,kv_dtype",
                         [("jax", "port", "float32"),
                          ("port", "jax", "float32"),
                          ("jax", "port", "int8")])
def test_restored_prefix_is_hit_with_the_local_stream(models, src_pkg,
                                                      dst_pkg, kv_dtype):
    prompt = _prompt(8, 26)              # 3 full blocks of 8 are cached
    local = _engine("port", models, kv_dtype=kv_dtype)
    want = _decode(local, local.prefill(0, prompt))
    src = _engine(src_pkg, models, kv_dtype=kv_dtype)
    src.prefill(0, prompt)
    assert src.prefix_probe(prompt) == 24
    ks, vs, n = src.extract_prefix_kv(prompt)
    assert n == 24 and ks[0].shape == (24, 4, 32)
    assert ks[0].dtype == np.float32
    dst = _engine(dst_pkg, models, kv_dtype=kv_dtype)
    assert dst.prefix_probe(prompt) == 0
    assert dst.restore_prefix(prompt, ks, vs, n) == 24
    assert dst.prefix_probe(prompt) == 24
    assert dst.restore_prefix(prompt, ks, vs, n) == 24   # touch, no copy
    assert len(dst.prefix_cache) == 3
    got = _decode(dst, dst.prefill(0, prompt))
    assert dst.last_prefill_stats["prefix_hit_tokens"] == 24
    assert got == want
    # another namespace sees nothing of it
    assert dst.prefix_probe(prompt, namespace="tenant-b") == 0


def test_int8_restore_writes_the_jax_codes_and_scales(models):
    prompt = _prompt(9, 26)
    src = _engine("port", models)
    src.prefill(0, prompt)
    ks, vs, n = src.extract_prefix_kv(prompt)
    port = _engine("port", models, kv_dtype="int8")
    ref = _engine("jax", models, kv_dtype="int8")
    assert port.restore_prefix(prompt, ks, vs, n, namespace="t") == 24
    assert ref.restore_prefix(prompt, ks, vs, n, namespace="t") == 24
    toks = [int(t) for t in prompt]
    for k in range(3):
        key = tprefix.prefix_key(toks[:(k + 1) * 8], "t")
        tb = port.prefix_cache._entries[key]
        jb = ref.prefix_cache._entries[key]
        for tl, jl in zip(port._pool, ref._pool):
            for name in ("k", "v", "k_scale", "v_scale"):
                np.testing.assert_array_equal(
                    getattr(tl, name)[tb].numpy(),
                    np.asarray(getattr(jl, name)[jb]))


def test_prefix_key_namespace_bytes_match_jax():
    from paddle_tpu.serving import prefix_cache as jprefix
    toks = list(_prompt(10, 16))
    for ns in (None, "tenant-a", "ünï"):
        assert tprefix.prefix_key(toks, ns) == jprefix.prefix_key(toks, ns)
    assert tprefix.prefix_key(toks, "a") != tprefix.prefix_key(toks)


# --------------------------------------------------------------- scheduler
def _oracle(models, prompts, max_new):
    sched = Scheduler(_engine("port", models), device="cpu")
    hs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    sched.run_until_idle()
    return [h.tokens for h in hs]


def test_scheduler_staged_placement_and_fallbacks(models):
    prompt, other = _prompt(11, 9), _prompt(12, 26)
    max_new = 6
    want, want_other = _oracle(models, [prompt, other], max_new)
    src = _engine("jax", models)
    first = src.prefill(0, prompt)
    ks, vs, plen = src.extract_kv(0)
    src.reset_slot(0)
    src.prefill(1, other)
    pks, pvs, pn = src.extract_prefix_kv(other)

    sched = Scheduler(_engine("port", models), device="cpu")
    good = sched.submit(prompt, max_new_tokens=max_new,
                        staged_kv=(ks, vs, plen, first))
    bad = sched.submit(prompt, max_new_tokens=max_new,
                       staged_kv=(ks[:1], vs[:1], plen, first))
    short = sched.submit(prompt, max_new_tokens=max_new,
                         staged_kv=(ks, vs, plen - 1, first))
    warm = sched.submit(other, max_new_tokens=max_new,
                        staged_prefix=(pks, pvs, pn, None))
    sched.run_until_idle()
    for h in (good, bad, short, warm):
        assert h.status == "DONE"
    assert good.adopted and not bad.adopted and not short.adopted
    assert good.tokens == bad.tokens == short.tokens == want
    assert warm.kv_restored_tokens == 24 and warm.prefix_hit
    assert warm.tokens == want_other
    assert sched.metrics()["adopted"] == 1


def test_preempted_staged_request_recomputes(models):
    prompt = _prompt(13, 9)
    max_new = 8
    want = _oracle(models, [prompt], max_new)[0]
    src = _engine("port", models)
    first = src.prefill(0, prompt)
    ks, vs, plen = src.extract_kv(0)
    eng = _engine("port", models)
    sched = Scheduler(eng, device="cpu")
    ensure, armed = eng.ensure_slot_capacity, []

    def flaky(slot, tokens=None):
        if armed:
            armed.pop()
            raise BlockAllocError("forced")
        return ensure(slot, tokens)
    eng.ensure_slot_capacity = flaky
    h = sched.submit(prompt, max_new_tokens=max_new,
                     staged_kv=(ks, vs, plen, first))
    sched.step()                          # adopts, decodes one token
    assert h.adopted and h._req._staged is None
    armed.append(True)                    # the next growth preempts it
    sched.run_until_idle()
    assert h.status == "DONE" and h.preempted == 1
    assert h.tokens == want
    assert sched.metrics()["adopted"] == 1
