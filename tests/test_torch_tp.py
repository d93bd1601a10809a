"""The port's tensor-parallel paged engine against the JAX package's, on
the CPU.

The JAX tiny GPT (hidden 128, 2 layers, 4 heads, vocab 1024) is built from
a fixed seed and its weights carried into the port with `load_jax_params`.
The JAX `TensorParallelPagedEngine` runs on 2 of the 8 virtual CPU devices
`tests/conftest.py` sets up (its default gather attention, as its own
tests run it); the port's runs `device="cpu"`, where the paged-attention
wrapper takes its plain version, with both shards on the CPU. Then:

  * greedy streams are token-exact against the JAX tp engine and the
    port's single-device paged engine, f32 and int8 (KV and weights);
  * each executable is captured once (a recording stand-in for the CUDA
    graphs: the first run of a name counts), and the capture counts
    equal the JAX trace counts;
  * `kv_shard_report` names each shard's device and heads/tp heads;
  * after prefill alone each port shard's pool equals the JAX device
    shard holding the same heads within 1e-4 (int8: codes and scales);
  * int8 decode codes split like the float weight, per-channel scales
    follow column splits and stay whole for row-parallel weights;
  * a single-device prefill hands its KV to the tp engine, a hot swap
    mid-stream keeps the stream, and the tp engine's bundle adopts back;
  * `hbm_accounting` gives each shard the single pool over tp and an
    int8 weight set about 1.25x the float one;
  * the partition table and the config's validation and round trip.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.serving import PagedEngineConfig as JPagedEngineConfig
from paddle_tpu.serving import PagedGenerationEngine as JPagedEngine
from paddle_tpu.serving.distributed import (
    TensorParallelEngineConfig as JTPConfig,
    TensorParallelPagedEngine as JTPEngine)
from paddle_tpu.text.models import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.serving import PagedGenerationEngine, graphs
from paddle_tpu_torch.serving.distributed import (
    TensorParallelEngineConfig, TensorParallelPagedEngine)
from paddle_tpu_torch.serving.distributed.tp import (
    Split, param_partition_specs, shard_index)
from paddle_tpu_torch.text.models import gpt_tiny
from paddle_tpu_torch.text.models.convert import load_jax_params

ENGINE_KW = dict(slots=4, max_len=64, block_size=8)
POOL_ATOL = 1e-4           # the port's serving tolerance
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


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 1000, n).tolist()


PROMPTS = [_prompt(90 + s, 9 + s) for s in range(4)]


class _RecordingExecutables(graphs.Executables):
    """The CUDA-graph bookkeeping on the CPU: the first run of a name
    counts as its capture; every run is eager."""

    def run(self, name, fn, inputs, safe=None, upload=True, device=None):
        if name not in self._graphs:
            self.capture_counts[name] = self.capture_counts.get(name, 0) + 1
            self._graphs[name] = True
        inputs.upload()
        return fn(), 0


def _port_tp(tm, **kw):
    eng = TensorParallelPagedEngine(
        tm, TensorParallelEngineConfig(**dict(ENGINE_KW, tp=2, **kw)),
        device="cpu")
    eng._exe = _RecordingExecutables(eng.device)
    return eng


def _stream(engine, prompts=PROMPTS, steps=STEPS):
    rows = [[engine.prefill(s, p)] for s, p in enumerate(prompts)]
    for _ in range(steps):
        engine.ensure_decode_capacity()
        out = engine.decode()
        for s in range(len(prompts)):
            rows[s].append(int(out[s]))
    return rows


def _jax_captures(trace_counts):
    """The JAX engine's traced executables as the port names them."""
    out = {}
    if trace_counts.get("decode"):
        out["decode"] = trace_counts["decode"]
    for b, n in trace_counts.get("prefill", {}).items():
        out[f"prefill[{b}]"] = n
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_tp_decode_token_exact_and_compile_once(models, quant):
    """Streams equal the JAX tp engine's and the port's single-device
    engine's token for token; decode and each prefill bucket are captured
    once, as the JAX engine traces them; each shard holds heads/tp."""
    jm, tm = models
    kw = dict(kv_dtype="int8", weight_dtype="int8") if quant else {}
    jtp = JTPEngine(jm, JTPConfig(tp=2, **ENGINE_KW, **kw))
    want = _stream(jtp)
    tp = _port_tp(tm, **kw)
    assert _stream(tp) == want
    one = PagedGenerationEngine(tm, device="cpu", **ENGINE_KW, **kw)
    assert _stream(one) == want
    assert tp.capture_counts == _jax_captures(jtp.trace_counts) == \
        {"decode": 1, "prefill[32]": 1}
    report = tp.kv_shard_report()
    assert report == {f"stage0.tp{t}": {"device": "cpu", "layers": [0, 2],
                                        "heads": 2} for t in range(2)}
    assert tp.kernel_launches == 0        # plain versions on the CPU


def _jax_shard(arr, head_lo):
    """The data of the JAX device shard of a heads-sharded pool array that
    starts at head `head_lo`."""
    axis = 2 if arr.ndim == 4 else 1
    for s in arr.addressable_shards:
        if (s.index[axis].start or 0) == head_lo:
            return np.asarray(s.data)
    raise AssertionError(f"no shard starts at head {head_lo}")


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_tp_pool_shards_match_jax_device_shards(models, quant):
    """After prefill alone (no decode step) each port shard's pools equal
    the JAX device shard with the same heads: f32 K/V within 1e-4, int8
    codes within one step and scales within 1e-4; a second prefill of the
    same bucket captures nothing."""
    jm, tm = models
    kw = dict(kv_dtype="int8") if quant else {}
    jtp = JTPEngine(jm, JTPConfig(tp=2, **ENGINE_KW, **kw))
    tp = _port_tp(tm, **kw)
    for s, p in enumerate(PROMPTS[:2]):
        assert tp.prefill(s, p) == jtp.prefill(s, p)
    assert tp.capture_counts == {"prefill[32]": 1}
    for sh in tp._stages[0].shards:
        lo = int(sh.name[-1]) * sh.heads
        for li, layer in enumerate(sh.pool):
            jlayer = jtp._pool[li]
            for field in layer._fields:
                got = getattr(layer, field).numpy()
                want = _jax_shard(getattr(jlayer, field), lo)
                assert got.shape == want.shape, (field, got.shape)
                if got.dtype == np.int8:
                    assert np.abs(got.astype(np.int32)
                                  - want.astype(np.int32)).max() <= 1, field
                else:
                    np.testing.assert_allclose(got, want, atol=POOL_ATOL,
                                               err_msg=field)


def test_tp_int8_codes_and_scales_split(models):
    """int8 decode weights split like the float weights: qkv's codes and
    scales take the shard's heads of q, k and v; out_proj's codes take the
    shard's input columns and keep every output channel's scale; the
    shards' codes reassemble the single-device engine's codes exactly."""
    _, tm = models
    tp = _port_tp(tm, weight_dtype="int8")
    one = PagedGenerationEngine(tm, device="cpu", weight_dtype="int8",
                                **ENGINE_KW)
    H = tm.cfg.hidden_size
    for name, split in (("blocks.0.attn.qkv.weight", Split(0, 3)),
                        ("blocks.0.attn.out_proj.weight", Split(1, 1)),
                        ("wte.weight", Split(0, 1))):
        full = one._decode_params[name]
        parts = [sh.decode_params[name] for sh in tp._stages[0].shards]
        idx = [shard_index(full["q"].shape[split.axis], split, 2, t)
               for t in range(2)]
        for t, part in enumerate(parts):
            assert torch.equal(part["q"],
                               full["q"].index_select(split.axis, idx[t]))
            want = full["scale"].index_select(0, idx[t]) \
                if split.axis == 0 else full["scale"]
            assert torch.equal(part["scale"], want)
    qkv = tp._stages[0].shards[0].decode_params["blocks.0.attn.qkv.weight"]
    assert tuple(qkv["q"].shape) == (3 * H // 2, H)
    assert tuple(qkv["scale"].shape) == (3 * H // 2, 1)


def test_tp_engine_handoff_and_swap_compose(models):
    """A single-device prefill hands its KV to the tp engine (the view
    splits it over the shards), a hot swap of the same weights mid-stream
    reslices every shard in place and the stream continues exactly, and
    the tp engine's bundle adopts back onto one device."""
    jm, tm = models
    prompt = PROMPTS[1]
    ref = PagedGenerationEngine(tm, device="cpu", **ENGINE_KW)
    want = _stream(ref, [prompt], 10)[0]
    jref = JPagedEngine(jm, JPagedEngineConfig(**ENGINE_KW))
    assert _stream(jref, [prompt], 10)[0] == want

    a = PagedGenerationEngine(tm, device="cpu", **ENGINE_KW)
    first = a.prefill(0, prompt)
    ks, vs, plen = a.extract_kv(0)
    tp = _port_tp(tm)
    tp.adopt_kv(0, ks, vs, plen, first)
    got = [first]
    for _ in range(3):
        tp.ensure_decode_capacity()
        got.append(int(tp.decode()[0]))
    storage = [t.data_ptr() for sh in tp._shards for t in sh.params.values()]
    tp.swap_params({k: v.detach().clone()
                    for k, v in tm.state_dict().items()})
    assert storage == [t.data_ptr() for sh in tp._shards
                       for t in sh.params.values()]
    for _ in range(3):
        tp.ensure_decode_capacity()
        got.append(int(tp.decode()[0]))
    assert got == want[:7]
    assert tp.capture_counts["decode"] == 1
    ks2, vs2, plen2 = tp.extract_kv(0)
    b = PagedGenerationEngine(tm, device="cpu", **ENGINE_KW)
    b.adopt_kv(0, ks2, vs2, plen2, got[-1])
    cont = []
    for _ in range(3):
        b.ensure_decode_capacity()
        cont.append(int(b.decode()[0]))
    assert cont == want[7:10]


def test_tp_hbm_accounting_per_shard(models):
    """Each shard's pool bytes are the single-device pool's over tp, every
    shard names its device, and the int8 weight set (float for prefill
    plus int8 codes for decode) is more than the float set and under
    1.5x of it."""
    _, tm = models
    one = PagedGenerationEngine(tm, device="cpu", **ENGINE_KW).hbm_accounting()
    tp = _port_tp(tm)
    acc = tp.hbm_accounting()
    assert set(acc["per_shard"]) == {"stage0.tp0", "stage0.tp1"}
    for rec in acc["per_shard"].values():
        assert rec["device"] == "cpu"
        assert rec["kv"] == one["kv_total"] // 2
    assert acc["kv_total"] == one["kv_total"]
    assert acc["per_device"]["cpu"]["total"] == acc["max_device_total"]
    q = _port_tp(tm, weight_dtype="int8").hbm_accounting()
    assert acc["weights_total"] < q["weights_total"] \
        < 1.5 * acc["weights_total"]


def test_tp_partition_table_and_config(models):
    """The partition table (the JAX model's `split_axis` facts in the
    port's [out, in] layout), the config's validation and its `.gencfg`
    round trip."""
    jm, tm = models
    specs = param_partition_specs(tm)
    assert specs["blocks.0.attn.qkv.weight"] == Split(0, 3)
    assert specs["blocks.1.mlp.fc2.weight"] == Split(1, 1)
    assert specs["wte.weight"] == Split(0, 1)
    assert specs["blocks.0.ln1.weight"] is None
    assert specs["wpe.weight"] is None
    # the same axes the JAX parameters annotate, transposed
    for name, p in jm.named_parameters():
        ax = getattr(p, "split_axis", None)
        split = specs[name]
        if ax is None:
            assert split is None, name
        elif p._data.ndim == 2 and name != "wte.weight":
            assert split.axis == 1 - int(ax), name
        else:
            assert split.axis == 0, name
    with pytest.raises(ValueError, match="divide num_heads"):
        TensorParallelPagedEngine(tm, TensorParallelEngineConfig(
            tp=3, **ENGINE_KW), device="cpu")
    with pytest.raises(ValueError, match="tp must be"):
        TensorParallelEngineConfig(tp=0)
    cfg = TensorParallelEngineConfig(tp=2, **ENGINE_KW)
    assert type(cfg)(**cfg.as_dict()).tp == 2
    assert cfg.as_dict() == JTPConfig(tp=2, attention_impl="kernel",
                                      **ENGINE_KW).as_dict()
