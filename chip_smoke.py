#!/usr/bin/env python3
"""Drive the PyTorch port (`paddle_tpu_torch`) end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any exception ends the run with a non-zero exit):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions;
  2. build: every CUDA kernel of the port, from `paddle_tpu_torch/csrc/`;
  3. kernel vs plain version on the card: the paged-attention kernel at the
     serving shapes (decode T=1 over ragged positions up to 1000, prefill
     T=64/128/512, int8 pools, a garbage block poisoned with NaN/inf,
     all-masked rows), with its time, the plain version's time, the
     `scaled_dot_product_attention` yardstick and the bound;
  4. the server: `Scheduler` over `PagedGenerationEngine(gpt_125m,
     attention_impl="kernel")` answers 16 greedy requests (prompts of 1 to
     700 tokens, eight sharing a 256-token prefix), with the kernel's
     launch count read just after;
  5. the same engine with int8 KV pools answers 4 requests;
  6. kernel path vs plain path at full width: first token + 8 greedy
     decode steps per slot must agree, a slot's comparison stopping at the
     first step where the plain path's top-2 logit gap is below 1e-3.

The line before the last is the `kernels` JSON summary; the last line is
`{"ok": true, "device": {...}}`. Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result. Longer output
goes to `chiprun_out/chip_smoke.json`.
"""
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): the HBM3 rate, and the operation rate
# for the type of the products: float32 (q is f32, and int8 codes are
# dequantised to f32 before they multiply it) outside the tensor cores, or
# bf16 dense on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"f32": 67e12, "int8": 67e12, "nan": 67e12, "bf16": 989e12}

ATOL = RTOL = 1e-5          # f32: the kernel's summation order differs
BF16_TOL = 1e-2             # bf16 output rounding (8 mantissa bits)
GAP_MIN = 1e-3              # phase 6: below this the argmax is a near-tie


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ timing
def _flush_l2(buf):
    buf.add_(1.0)             # 256 MB through the 50 MB L2


def time_ms(fn, flush, iters=20, warmup=3):
    """Mean device time of fn() over `iters` launches, each timed by its
    own CUDA events after an L2 flush (the serving path finds the cache
    cold: twelve layers' pools cycle through it). A ~1 ms sleep kernel
    after the flush lets the host enqueue fn's launches before the card
    reaches them, so the events time the device work, not the host's
    launch overhead."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def host_us(fn, iters=200):
    """Host time of one call of fn() (launch overhead), with the card
    kept busy so no call waits for it."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


# -------------------------------------------------------- kernel test cases
def paged_case(seed, S, T, pos, *, H=12, D=64, bs=16, nb=64, kind="f32",
               poison=True, all_nan=False):
    """A paged state as the engine lays it out: every position up to
    pos+T-1 is backed by a real block, later table entries point at the
    garbage block 0 (poisoned with NaN/inf when `poison`)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    N = 1 + S * nb
    shape = (N, bs, H, D)
    fdt = torch.bfloat16 if kind == "bf16" else torch.float32
    q = torch.randn((S, T, H, D), generator=g, device="cuda").to(fdt)
    out = {"q": q}
    if kind == "int8":
        out["k"] = torch.randint(-127, 128, shape, generator=g,
                                 device="cuda", dtype=torch.int8)
        out["v"] = torch.randint(-127, 128, shape, generator=g,
                                 device="cuda", dtype=torch.int8)
        out["ks"] = torch.rand((N, H), generator=g, device="cuda") * 4 + .1
        out["vs"] = torch.rand((N, H), generator=g, device="cuda") * 4 + .1
        if poison:
            out["ks"][0] = float("nan")
            out["vs"][0] = float("inf")
    else:
        out["k"] = torch.randn(shape, generator=g, device="cuda").to(fdt)
        out["v"] = torch.randn(shape, generator=g, device="cuda").to(fdt)
        if all_nan:
            out["k"].fill_(float("nan"))
            out["v"].fill_(float("nan"))
        elif poison:
            out["k"][0] = float("nan")
            out["v"][0] = float("inf")
    perm = torch.randperm(N - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    tables = torch.zeros((S, nb), dtype=torch.int32)
    at = 0
    for s in range(S):
        live = max(0, min(nb, -(-(pos[s] + T) // bs)))
        tables[s, :live] = perm[at:at + live].to(torch.int32)
        at += live
    out["tables"] = tables.cuda()
    out["pos"] = torch.tensor(pos, dtype=torch.int32, device="cuda")
    return out


def case_bound(c, kind):
    """Least time for this call on an H100: bytes each input read once
    (the visible K/V rows, q, the tables, the scale rows of the visited
    blocks) and the output written once, against the products over the
    visible keys (4*D flops per query-key pair and head)."""
    q = c["q"]
    S, T, H, D = q.shape
    bs = c["k"].shape[1]
    elsize = c["k"].element_size()
    L = c["tables"].shape[1] * bs
    pos = c["pos"].tolist()
    rows = sum(max(0, min(p + T, L)) for p in pos)
    pairs = sum(max(0, min(p + i + 1, L)) for p in pos for i in range(T))
    nbytes = 2 * rows * H * D * elsize + 2 * q.numel() * q.element_size() \
        + c["tables"].numel() * 4 + len(pos) * 4
    if "ks" in c:
        nbytes += 2 * sum(-(-max(0, min(p + T, L)) // bs) for p in pos) \
            * H * 4
    flops = 4 * pairs * H * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S[kind] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def run_kernel_cases(flush):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.serving import blocks
    from paddle_tpu_torch.ops.paged_attention import paged_attention

    rng = __import__("random").Random(0)
    ragged = [0, 15, 16, 17, 255, 511, 777, 1000]
    cases = [
        ("decode_f32", dict(S=8, T=1, pos=ragged), "f32"),
        ("decode_f32_rand", dict(S=8, T=1,
                                 pos=[rng.randint(0, 1000) for _ in range(8)]),
         "f32"),
        ("prefill_f32_T64", dict(S=2, T=64, pos=[0, 256]), "f32"),
        ("prefill_f32_T128", dict(S=2, T=128, pos=[0, 256]), "f32"),
        ("prefill_f32_T512", dict(S=2, T=512, pos=[0, 256]), "f32"),
        # a tile with fewer rows than the kernel's 16, and 8-token blocks
        # (8 blocks per staged chunk instead of 4)
        ("prefill_f32_T7", dict(S=3, T=7, pos=[0, 61, 300]), "f32"),
        ("decode_f32_bs8", dict(S=8, T=1, pos=ragged[:7] + [500], bs=8),
         "f32"),
        ("decode_int8", dict(S=8, T=1, pos=ragged), "int8"),
        ("prefill_int8_T128", dict(S=2, T=128, pos=[0, 256]), "int8"),
        ("decode_bf16", dict(S=8, T=1, pos=ragged), "bf16"),
        ("all_masked", dict(S=8, T=1, pos=[-1] * 8), "nan"),
    ]
    results = []
    for i, (name, shape, kind) in enumerate(cases):
        c = paged_case(100 + i, shape["S"], shape["T"], shape["pos"],
                       bs=shape.get("bs", 16),
                       kind="f32" if kind == "nan" else kind,
                       all_nan=kind == "nan")
        q, k, v, tb, pos = c["q"], c["k"], c["v"], c["tables"], c["pos"]
        if kind == "int8":
            def kern():
                return paged_attention(q, k, v, tb, pos, k_scale=c["ks"],
                                       v_scale=c["vs"])

            def plain():
                return blocks.attend_quant(q, k, v, c["ks"], c["vs"], tb,
                                           pos)
            kd = blocks.gather_quant(k, c["ks"], tb)
            vd = blocks.gather_quant(v, c["vs"], tb)
        else:
            def kern():
                return paged_attention(q, k, v, tb, pos)

            if kind == "bf16":
                # the plain version in f32 over the same bf16 values
                def plain():
                    return blocks.attend(q.float(), k.float(), v.float(),
                                         tb, pos)
            else:
                def plain():
                    return blocks.attend(q, k, v, tb, pos)
            kd, vd = blocks.gather(k, tb), blocks.gather(v, tb)
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = BF16_TOL if kind == "bf16" else ATOL
        rtol = BF16_TOL if kind == "bf16" else RTOL
        bad = err > tol + rtol * want.float().abs()
        finite = bool(torch.isfinite(got).all())
        max_err = float(err.max())
        if not finite or bool(bad.any()):
            raise AssertionError(
                f"{name}: kernel disagrees with the plain version "
                f"(max_abs_err={max_err}, finite={finite})")
        if kind == "nan" and bool((got != 0).any()):
            raise AssertionError(f"{name}: all-masked rows must be 0")
        kms = time_ms(kern, flush)
        khost = host_us(kern)
        pms = time_ms(plain, flush)
        lib_ms = None
        if kind != "nan":
            # yardstick: SDPA over the gathered dense view, same mask
            S, T = q.shape[0], q.shape[1]
            L = kd.shape[1]
            lim = pos.long()[:, None] + torch.arange(T, device="cuda")
            mask = (torch.arange(L, device="cuda")[None, None, :]
                    <= lim[:, :, None])[:, None]
            qd = q.transpose(1, 2)
            kt = kd.to(q.dtype).transpose(1, 2).contiguous()
            vt = vd.to(q.dtype).transpose(1, 2).contiguous()
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qd, kt, vt, attn_mask=mask), flush)
        bound, bound_by, nbytes, flops = case_bound(c, kind)
        rec = {"case": name, "S": int(q.shape[0]), "T": int(q.shape[1]),
               "H": int(q.shape[2]), "D": int(q.shape[3]),
               "bs": int(k.shape[1]), "pos": shape["pos"], "kind": kind,
               "max_abs_err": max_err, "tol": [tol, rtol], "ms": kms,
               "host_us": khost, "plain_ms": pms, "library_ms": lib_ms,
               "bound_ms": bound,
               "bound_by": bound_by, "bytes": nbytes, "flops": flops}
        results.append(rec)
        log(f"case {name}: S={rec['S']} T={rec['T']} H={rec['H']} "
            f"D={rec['D']} bs={rec['bs']} max_abs_err={max_err:.3e} "
            f"(tol {tol}/{rtol}) kernel_ms={kms:.4f} host_us={khost:.1f} "
            f"plain_ms={pms:.4f} "
            f"sdpa_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
            f"bound_ms={bound:.5f} ({bound_by})")
    return results


# ------------------------------------------------------------------ serving
def serve(engine, prompts, max_new):
    """Submit every prompt, run the scheduler until idle; returns
    (handles, metrics, wall seconds)."""
    from paddle_tpu_torch.serving import Scheduler
    sched = Scheduler(engine, max_queue=64, device=engine.device)
    handles = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    t0 = time.perf_counter()
    sched.run_until_idle()      # every step ends in a host read of tokens
    wall = time.perf_counter() - t0
    for h in handles:
        if h.status != "DONE" or len(h.tokens) != max_new:
            raise AssertionError(f"request {h.request_id} ended {h.status} "
                                 f"with {len(h.tokens)} tokens")
    return handles, sched.metrics(), wall


def make_prompts(seed, lengths, shared_from, vocab):
    import numpy as np
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, vocab, 256).tolist()
    out = []
    for i, n in enumerate(lengths):
        tail = rng.randint(0, vocab, n).tolist()
        out.append((shared + tail)[:n] if i >= shared_from and n > 256
                   else tail)
    return out


def compare_paths(model, prompts, steps=8):
    """Phase 6: kernel engine vs gather engine, same weights, on the card.
    Returns (compared steps, steps dropped by the near-tie rule)."""
    import torch
    from paddle_tpu_torch.serving import PagedGenerationEngine
    engs = {impl: PagedGenerationEngine(
        model, slots=len(prompts), block_size=16, attention_impl=impl,
        max_len=model.cfg.max_position_embeddings, device=model.device)
            for impl in ("kernel", "gather")}
    gaps = []                 # per step: plain top-2 gap per slot
    plain = engs["gather"]
    sel, sel_slots = plain._select, plain._select_slots

    def gap(logits):
        top = torch.topk(logits.float(), 2, dim=-1).values
        return (top[..., 0] - top[..., 1]).reshape(-1).tolist()

    def cap_select(logits, slot):
        gaps.append(("prefill", slot, gap(logits)[0]))
        return sel(logits, slot)

    def cap_slots(logits):
        gaps.append(("decode", None, gap(logits)))
        return sel_slots(logits)
    plain._select, plain._select_slots = cap_select, cap_slots

    toks = {impl: [[] for _ in prompts] for impl in engs}
    for impl, eng in engs.items():
        for s, p in enumerate(prompts):
            toks[impl][s].append(eng.prefill(s, p))
        for _ in range(steps):
            out = eng.decode()
            for s in range(len(prompts)):
                toks[impl][s].append(int(out[s]))
    slot_gaps = [[None] * (steps + 1) for _ in prompts]
    di = 0
    for kind, slot, g in gaps:
        if kind == "prefill":
            slot_gaps[slot][0] = g
        else:
            di += 1
            for s in range(len(prompts)):
                slot_gaps[s][di] = g[s]
    compared = dropped = 0
    for s in range(len(prompts)):
        for t in range(steps + 1):
            if slot_gaps[s][t] < GAP_MIN:
                dropped += steps + 1 - t
                break
            if toks["kernel"][s][t] != toks["gather"][s][t]:
                raise AssertionError(
                    f"slot {s} step {t}: kernel token "
                    f"{toks['kernel'][s][t]} != plain "
                    f"{toks['gather'][s][t]} (plain gap "
                    f"{slot_gaps[s][t]:.3e})")
            compared += 1
    launches = engs["kernel"].kernel_launches
    if launches <= 0:
        raise AssertionError("phase 6: the kernel engine launched nothing")
    return compared, dropped


def profile_decode(model, prompts, steps=8):
    """Decode steps of a full 8-slot kernel engine, first untraced (host
    clock), then under torch.profiler: device busy time per step, the
    kernels launched per step and the largest kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving import PagedGenerationEngine
    eng = PagedGenerationEngine(model, slots=len(prompts), max_len=1024,
                                block_size=16, attention_impl="kernel",
                                device=model.device)
    for s, p in enumerate(prompts):
        eng.prefill(s, p)
    eng.decode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.decode()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.decode()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / steps * 1e3
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)
    busy_ms = sum(dev_us(e) for e in kernels) / steps / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    return {"steps": steps, "slots": len(prompts),
            "positions": [int(x) for x in eng.slot_positions()],
            "step_ms_untraced": wall_ms, "step_ms_traced": traced_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": (1 - busy_ms / traced_ms
                                  if busy_ms else None),
            "kernels_per_step": sum(e.count for e in kernels) / steps,
            "top": [{"name": e.key[:60], "ms_per_step":
                     dev_us(e) / steps / 1e3, "count": e.count // steps}
                    for e in top]}


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only "
              "on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "paddle_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository "
              "(paddle_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    report = {}

    # 1. device ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {kind}")
    report["card"] = smi
    # the plain versions are held at full float32 too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build ------------------------------------------------------------------
    from paddle_tpu_torch._kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"built {sorted(libs)} in {report['build_s']:.1f} s")
    for line in build.ptxas_report("paged_attention").splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas:", line.strip())

    # 3. kernel vs plain --------------------------------------------------------
    flush_buf = torch.empty(64 * 1024 * 1024, device="cuda")
    cases = run_kernel_cases(lambda: _flush_l2(flush_buf))
    report["cases"] = cases
    del flush_buf

    # 4. the server ---------------------------------------------------------------
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import PagedGenerationEngine
    from paddle_tpu_torch.text.models import gpt_125m
    model = gpt_125m(device="cuda", seed=0)
    cfg = model.cfg
    lengths = [1, 5, 17, 64, 100, 200, 255, 512,
               257, 290, 300, 333, 400, 480, 600, 700]
    prompts = make_prompts(0, lengths, shared_from=8, vocab=cfg.vocab_size)
    engine = PagedGenerationEngine(model, slots=8, max_len=1024,
                                   block_size=16, attention_impl="kernel",
                                   device="cuda")
    pa.launches = 0
    handles, m, wall = serve(engine, prompts, max_new=32)
    launches = pa.launches
    prefills = len(prompts) + m["requests"]["preempted"]
    if launches <= 0:
        raise AssertionError("the server never launched the kernel")
    if launches != cfg.num_layers * (m["decode_steps"] + prefills):
        raise AssertionError(
            f"{launches} launches, want {cfg.num_layers} per forward over "
            f"{m['decode_steps']} decode steps + {prefills} prefills")
    if m["prefix_hits"] < 1:
        raise AssertionError("no prefix-cache hit on shared prompts")
    ttfts = [h.ttft_s for h in handles]
    serve_rec = {"requests": len(prompts), "max_new_tokens": 32,
                 "kernel_launches": launches,
                 "launches_per_forward": cfg.num_layers,
                 "decode_steps": m["decode_steps"], "prefills": prefills,
                 "decode_step_ms": m["decode_step_ms"],
                 "decode_tokens_per_s": m["decode_tokens_per_s"],
                 "ttft_s_mean": sum(ttfts) / len(ttfts),
                 "ttft_s_max": max(ttfts), "prefix_hits": m["prefix_hits"],
                 "wall_s": wall, "card": smi}
    report["serve"] = serve_rec
    log(f"serve gpt_125m kernel: {len(prompts)} requests done, "
        f"launches={launches} ({cfg.num_layers}/forward x "
        f"{m['decode_steps']} decode + {prefills} prefill), "
        f"decode_step_ms={m['decode_step_ms']:.3f} "
        f"decode_tok_s={m['decode_tokens_per_s']:.1f} "
        f"ttft_mean_s={serve_rec['ttft_s_mean']:.4f} "
        f"ttft_max_s={serve_rec['ttft_s_max']:.4f} "
        f"prefix_hits={m['prefix_hits']} wall_s={wall:.2f} [{smi}]")

    # 5. int8 KV ---------------------------------------------------------------------
    eng8 = PagedGenerationEngine(model, slots=8, max_len=1024,
                                 block_size=16, attention_impl="kernel",
                                 kv_dtype="int8", device="cuda")
    pa.launches = 0
    _, m8, wall8 = serve(eng8, prompts[8:12], max_new=32)
    launches8 = pa.launches
    if launches8 <= 0:
        raise AssertionError("the int8 server never launched the kernel")
    report["serve_int8"] = {"requests": 4, "kernel_launches": launches8,
                            "decode_step_ms": m8["decode_step_ms"],
                            "wall_s": wall8}
    log(f"serve gpt_125m int8 KV: 4 requests done, launches={launches8} "
        f"decode_step_ms={m8['decode_step_ms']:.3f} [{smi}]")
    del eng8, engine

    # where a decode step's time goes ------------------------------------------------
    prof = profile_decode(model, prompts[8:16])
    report["profile"] = prof
    log(f"profile decode (8 slots at positions {prof['positions']}): "
        f"step {prof['step_ms_untraced']:.3f} ms untraced, "
        f"{prof['step_ms_traced']:.3f} ms traced, device busy "
        f"{prof['device_busy_ms_per_step']:.3f} ms/step, idle share "
        f"{prof['device_idle_share']}, "
        f"{prof['kernels_per_step']:.0f} kernels/step [{smi}]")
    for t in prof["top"]:
        log(f"  {t['ms_per_step']:.4f} ms/step x{t['count']} {t['name']}")

    # 6. kernel path vs plain path ------------------------------------------------
    compared, dropped = compare_paths(model, prompts[:4] + prompts[8:12])
    report["parity"] = {"compared_steps": compared,
                        "dropped_near_ties": dropped, "gap_min": GAP_MIN}
    log(f"parity kernel vs plain path: {compared} slot-steps agree, "
        f"{dropped} dropped by the top-2 gap < {GAP_MIN} rule")
    if compared == 0:
        raise AssertionError("phase 6 compared nothing")

    # summary ------------------------------------------------------------------------
    dec = next(c for c in cases if c["case"] == "decode_f32")
    dec8 = next(c for c in cases if c["case"] == "decode_int8")
    err_f = max(c["max_abs_err"] for c in cases if c["kind"] in ("f32",
                                                                  "nan"))
    err_8 = max(c["max_abs_err"] for c in cases if c["kind"] == "int8")

    def entry(name, replaces, launches, c, err):
        return {"name": name, "route": "cuda",
                "source": "paddle_tpu_torch/csrc/paged_attention.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c["library_ms"]}
    kernels = {"kernels": [
        entry("paged_attention", "paddle_tpu/ops/pallas/paged_attention.py:75",
              launches, dec, err_f),
        entry("paged_attention_int8",
              "paddle_tpu/ops/pallas/paged_attention.py:110", launches8, dec8,
              err_8)]}
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"total {report['total_s']:.1f} s")
    log(smi)
    log(json.dumps(kernels))
    assert all(math.isfinite(x["ms"]) for x in kernels["kernels"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
