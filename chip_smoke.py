#!/usr/bin/env python3
"""Drive the PyTorch port (`paddle_tpu_torch`) end to end on one NVIDIA GPU.

    python3 chip_smoke.py               # every phase, as the driver runs it
    python3 chip_smoke.py --flash-only  # phases 1, 2 and 7 only

Phases (any exception ends the run with a non-zero exit):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions;
  2. build: every CUDA kernel of the port, from `paddle_tpu_torch/csrc/`;
  3. kernel vs plain version on the card: the paged-attention kernel at the
     serving shapes (decode T=1 over ragged positions up to 1000, prefill
     T=64/128/512, int8 pools, a garbage block poisoned with NaN/inf,
     all-masked rows, and decode at the edges of the kernel's KV splits:
     key counts one below, at and one above a split boundary, the full
     table, a pos = -1 slot beside long ones, 16- and 8-token blocks, in
     f32, int8 and bf16; speculative verify windows on the window kernel,
     T=5 in f32, int8 and bf16 and T=2, at positions 0 to the table's
     last key with windows across a block edge, T=5 windows at the first
     split edge, beside the T=1 kernel at the same positions; T=16 and
     T=17, the two sides of the window/tile boundary; the tile kernel at
     the serving path's own prefill shapes, one slot at T=32 from
     position 0 and T=256 after a 256-token prefix, and bf16 at T=128),
     every case launched twice and required to repeat bit for bit, with
     its time, host time per call, the plain version's time, the
     `scaled_dot_product_attention` yardstick and the bound;
  4. the server: `Scheduler` over `PagedGenerationEngine(gpt_125m,
     attention_impl="kernel")` answers 16 greedy requests (prompts of 1 to
     700 tokens, eight sharing a 256-token prefix), with the kernel's
     launch count read just after (12 a forward: decode steps at T=1,
     prefills on the tile path);
  5. the same engine with int8 KV pools answers 4 requests;
  6. kernel path vs plain path at full width: first token + 8 greedy
     decode steps per slot must agree, a slot's comparison stopping at the
     first step where the plain path's top-2 logit gap is below 1e-3;
  7. flash-attention kernels (forward, dQ, dK/dV) vs their plain versions
     on the card: the GPT-350M training shape (B=8, H=16, S=1024, D=64,
     bf16, causal), f32 causal and non-causal, a ragged S=200, D=128, an
     additive (B,1,S,S) mask with fully masked rows, dropout 0.1 and GQA
     16/4, the same options in bf16, and bf16 at the edges of the wgmma
     kernels' 128-row tiles (S=64, 129 and 1000 causal, S=1024
     non-causal, D=128 at S=1024, GQA 16/4 at S=200); with each kernel's
     time, the plain version's time, the `scaled_dot_product_attention`
     forward and backward yardsticks (and the kernel's ratio to them) and
     the bound at the training shape (phase 7a); the backward kernels
     are launched twice on every case and must repeat bit for bit. Phase
     2 prints the registers, spills and shared memory of the wgmma
     kernels (forward, dQ and dK/dV builds). With
     --flash-only the script stops after phase 7, runs every case even
     after a failure, and exits 1 if any failed;
  8. the training step: `make_train_step` on GPT-350M (vocab 50304,
     S=1024, hidden 1024, 24 layers, 16 heads, bf16, no remat, lr 2e-4)
     at B=8 on one fixed batch, 3 warm-up and 10 timed steps: step ms,
     tokens/s, peak memory, MFU, one profiled step, exactly 24 launches
     of each flash kernel a step, and the device ms of the step's parts
     (forward, backward, clip + AdamW) and of the LM head's logits
     product;
  9. training kernel path vs plain path at full width (depth 2, f32, B=2,
     3 steps from the same weights): flash kernels + remat + fused CE
     against dense attention + no remat + unfused CE;
 10. the speculative server: `Scheduler` over `SpeculativeEngine(gpt_125m,
     gamma=4, draft_layers=2, attention_impl="kernel")` answers phase 4's
     16 requests (every verify window on the paged kernel at T=5, the
     draft on its dense cache: exactly 12 paged launches per verify round
     on the window path and per prefill on the tile path, no block
     leaked), with its acceptance rate, tokens a round, tokens/s, draft
     and verify host time, one profiled round (with the paged kernel's
     device time);
     its streams must equal a one-token engine's on 8 prompts, a slot's
     comparison stopping at the first step whose top-2 gap is below 1e-3;
 11. int8 decode weights: teacher-forced against the float engine (8
     slots x 16 steps; greedy match >= 0.99 where the float gap >= 1e-3,
     mean logit KL < 1e-3), the device ms of the per-forward dequant;
     speculative decode with int8 weights and KV agrees >= 0.9 with the
     one-token int8 engine; a weight swap to a clone in the middle of
     phase 10's serving leaves every stream unchanged, and a swap with a
     wrong-shaped tensor is refused.

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
SPEC_AGREE = 0.9            # phase 11: spec x int8 vs one-token int8
QUANT_MATCH = 0.99          # phase 11: int8 weights vs float, greedy
QUANT_KL = 1e-3             # phase 11: mean KL(float || int8 weights)
BF16_TOL = 1e-2             # bf16 output rounding (8 mantissa bits)
GAP_MIN = 1e-3              # phase 6: below this the argmax is a near-tie
BF16_PEAK = 989e12          # H100 SXM dense bf16, for MFU
# phase 9 (f32, lr 2e-4): the paths sum in other orders, and Adam divides
# each gradient element by its own running scale, so where an element's
# gradient is near zero (the key bias's is zero in exact arithmetic) its
# rounding noise moves the weight by up to about lr. Each leaf's update as
# a whole must agree to 1e-2: a wrong gradient changes it at order 1.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_ATOL = 2e-4     # lr
TRAIN_UPDATE_RTOL = 1e-2    # |dW_kernel - dW_plain| / |dW_plain| per leaf


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


def paged_cases(sp):
    """Phase 3's cases: (name, shape, kind) for a decode split of `sp`
    keys."""
    rng = __import__("random").Random(0)
    ragged = [0, 15, 16, 17, 255, 511, 777, 1000]
    # verify windows: from 0 to the window that ends on the table's last
    # key (1024 keys), two of them across a 16-token block edge
    verify5 = [0, 12, 14, 255, 500, 777, 1000, 1019]
    verify2 = [0, 12, 15, 255, 500, 777, 1000, 1022]

    def edges(L):
        """Decode positions at the kernel's split edges: key counts one
        below, at and one above the first and the second split boundary,
        the full table, and a slot with no key (pos = -1) beside them."""
        return [sp - 2, sp - 1, sp, 2 * sp - 2, 2 * sp - 1, 2 * sp, L - 1,
                -1]
    return [
        ("decode_f32", dict(S=8, T=1, pos=ragged), "f32"),
        ("decode_f32_rand", dict(S=8, T=1,
                                 pos=[rng.randint(0, 1000) for _ in range(8)]),
         "f32"),
        ("prefill_f32_T64", dict(S=2, T=64, pos=[0, 256]), "f32"),
        ("prefill_f32_T128", dict(S=2, T=128, pos=[0, 256]), "f32"),
        ("prefill_f32_T512", dict(S=2, T=512, pos=[0, 256]), "f32"),
        # a 7-row window (the window kernel's 8-row instance), and
        # 8-token blocks
        ("prefill_f32_T7", dict(S=3, T=7, pos=[0, 61, 300]), "f32"),
        ("decode_f32_bs8", dict(S=8, T=1, pos=ragged[:7] + [500], bs=8),
         "f32"),
        ("decode_int8", dict(S=8, T=1, pos=ragged), "int8"),
        ("prefill_int8_T128", dict(S=2, T=128, pos=[0, 256]), "int8"),
        ("decode_bf16", dict(S=8, T=1, pos=ragged), "bf16"),
        ("all_masked", dict(S=8, T=1, pos=[-1] * 8), "nan"),
        # the decode kernel's split edges, with 16- and 8-token blocks
        ("decode_edges_f32", dict(S=8, T=1, pos=edges(1024)), "f32"),
        ("decode_edges_int8", dict(S=8, T=1, pos=edges(1024)), "int8"),
        ("decode_edges_bf16", dict(S=8, T=1, pos=edges(1024)), "bf16"),
        ("decode_edges_bs8_f32", dict(S=8, T=1, pos=edges(512), bs=8),
         "f32"),
        ("decode_edges_bs8_int8", dict(S=8, T=1, pos=edges(512), bs=8),
         "int8"),
        ("decode_edges_bs8_bf16", dict(S=8, T=1, pos=edges(512), bs=8),
         "bf16"),
        # speculative verify windows (gamma 4 and 1) on the window
        # kernel, and the T=1 kernel at the same positions
        ("verify_f32_T5", dict(S=8, T=5, pos=verify5), "f32"),
        ("verify_int8_T5", dict(S=8, T=5, pos=verify5), "int8"),
        ("verify_f32_T2", dict(S=8, T=2, pos=verify2), "f32"),
        ("decode_f32_verify_pos", dict(S=8, T=1, pos=verify5), "f32"),
        ("verify_bf16_T5", dict(S=8, T=5, pos=verify5), "bf16"),
        # T=5 windows at the first split edge: ending on its last key,
        # straddling it by 1..4 keys, and one past the second edge
        ("verify_f32_T5_split_edge",
         dict(S=8, T=5, pos=[sp - 5, sp - 4, sp - 3, sp - 2, sp - 1,
                             2 * sp - 2, -1, 1019]), "f32"),
        # the boundary of the window path (T <= 16) and the tile path
        ("window_f32_T16", dict(S=8, T=16, pos=[0, 5, 112, 127, 255, 500,
                                                1000, 1008]), "f32"),
        ("prefill_f32_T17", dict(S=8, T=17, pos=[0, 5, 111, 127, 255, 500,
                                                 999, 1007]), "f32"),
        ("prefill_bf16_T128", dict(S=2, T=128, pos=[0, 256]), "bf16"),
        # the serving path's own prefill shapes: one slot, a bucket of
        # 32 at position 0 and of 256 after the 256-token prefix hit
        ("prefill_f32_S1_T32", dict(S=1, T=32, pos=[0]), "f32"),
        ("prefill_f32_S1_T256", dict(S=1, T=256, pos=[256]), "f32"),
    ]


def run_kernel_cases(flush):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.serving import blocks
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.paged_attention import paged_attention

    cases = paged_cases(pa.decode_split_keys())
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
        again = kern()
        want = plain()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two launches on the same inputs "
                                 "differ (the kernel must repeat bit for "
                                 "bit)")
        # query row i of slot s sees no key iff pos[s] + i < 0
        empty = pos[:, None] + torch.arange(q.shape[1], device="cuda") < 0
        if bool(empty.any()) and bool((got[empty] != 0).any()):
            raise AssertionError(f"{name}: rows with no visible key must be "
                                 "exact zeros")
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


def profile_steps(step, steps):
    """One warm-up call of step() (which ends in a host read), `steps`
    calls untraced (host clock), then `steps` under torch.profiler: device
    busy time per call, the kernels launched per call and the largest
    kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / steps * 1e3
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)
    busy_ms = sum(dev_us(e) for e in kernels) / steps / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    paged = [e for e in kernels if "paged_" in e.key]
    return {"steps": steps,
            "step_ms_untraced": wall_ms, "step_ms_traced": traced_ms,
            "device_busy_ms_per_step": busy_ms,
            "paged_ms_per_step": sum(dev_us(e) for e in paged) / steps / 1e3,
            "paged_launches_per_step": sum(e.count for e in paged) / steps,
            "device_idle_share": (1 - busy_ms / traced_ms
                                  if busy_ms else None),
            "kernels_per_step": sum(e.count for e in kernels) / steps,
            "top": [{"name": e.key[:60], "ms_per_step":
                     dev_us(e) / steps / 1e3, "count": e.count // steps}
                    for e in top]}


def profile_decode(model, prompts, steps=8):
    """One-token decode steps of a full 8-slot kernel engine."""
    from paddle_tpu_torch.serving import PagedGenerationEngine
    eng = PagedGenerationEngine(model, slots=len(prompts), max_len=1024,
                                block_size=16, attention_impl="kernel",
                                device=model.device)
    for s, p in enumerate(prompts):
        eng.prefill(s, p)
    rec = profile_steps(eng.decode, steps)
    rec.update(slots=len(prompts),
               positions=[int(x) for x in eng.slot_positions()])
    return rec


def log_profile(what, prof, smi):
    log(f"profile {what} (8 slots at positions {prof['positions']}): "
        f"{prof['step_ms_untraced']:.3f} ms untraced, "
        f"{prof['step_ms_traced']:.3f} ms traced, device busy "
        f"{prof['device_busy_ms_per_step']:.3f} ms each, idle share "
        f"{prof['device_idle_share']}, "
        f"{prof['kernels_per_step']:.0f} kernels each; the paged kernel "
        f"{prof['paged_ms_per_step']:.4f} ms in "
        f"{prof['paged_launches_per_step']:.0f} launches [{smi}]")
    for t in prof["top"]:
        log(f"  {t['ms_per_step']:.4f} ms x{t['count']} {t['name']}")


# --------------------------------------------------- speculative serving
# phase 10's engine: the issue's configuration of the speculative server
SPEC = dict(slots=8, max_len=1024, block_size=16, attention_impl="kernel",
            gamma=4, draft_layers=2)


def top2_gaps(logits):
    """Top-2 logit gap of each row of a [rows, V] array."""
    import numpy as np
    top = np.sort(np.asarray(logits, np.float64), axis=-1)[:, -2:]
    return top[:, 1] - top[:, 0]


def serve_spec(model, prompts, smi):
    """Phase 10: the speculative server answers phase 4's requests. Returns
    (record, handles, window launches, prefill-tile launches)."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import SpeculativeEngine
    cfg = model.cfg
    eng = SpeculativeEngine(model, device=model.device, **SPEC)
    rounds = []
    spec_round = eng.decode_many

    def recorded():
        out = spec_round()
        rounds.append(eng.last_spec_stats)
        return out
    eng.decode_many = recorded
    pa.launches = pa.launches_window = pa.launches_prefill = 0
    handles, m, wall = serve(eng, prompts, max_new=32)
    launches, window = pa.launches, pa.launches_window
    prefill = pa.launches_prefill
    n_rounds = m["decode_steps"]
    prefills = len(prompts) + m["requests"]["preempted"]
    if launches != cfg.num_layers * (n_rounds + prefills):
        raise AssertionError(
            f"phase 10: {launches} paged launches, want {cfg.num_layers} "
            f"per forward over {n_rounds} verify rounds + {prefills} "
            "prefills (the draft must make none)")
    if window != cfg.num_layers * n_rounds or \
            prefill != cfg.num_layers * prefills:
        raise AssertionError(
            f"phase 10: {window} window and {prefill} tile launches, want "
            f"{cfg.num_layers} a verify round on the window path and "
            f"{cfg.num_layers} a prefill on the tile path; "
            f"{launches - window - prefill} at T=1 (the draft's or a "
            "one-token decode's)")
    cached = len(eng.prefix_cache)
    eng.prefix_cache.evict(eng.block_pool.capacity)
    if eng.block_pool.in_use != 0:
        raise AssertionError(f"phase 10: {eng.block_pool.in_use} blocks "
                             "still in use after every request ended")
    draft_ms = sum(r["draft_s"] for r in rounds) / len(rounds) * 1e3
    verify_ms = sum(r["verify_s"] for r in rounds) / len(rounds) * 1e3
    rec = {"requests": len(prompts), "max_new_tokens": 32, **SPEC,
           "kernel_launches": launches, "kernel_launches_window": window,
           "kernel_launches_prefill": prefill, "rounds": n_rounds,
           "prefills": prefills, "preempted": m["requests"]["preempted"],
           "spec_proposed": m["spec_proposed"],
           "spec_accepted": m["spec_accepted"],
           "acceptance_rate": m["spec_acceptance_rate"],
           "decode_tokens": m["decode_tokens"],
           "tokens_per_round": m["decode_tokens"] / n_rounds,
           "tokens_per_slot_round": 1 + SPEC["gamma"]
           * m["spec_acceptance_rate"],
           "round_ms": m["decode_step_ms"],
           "decode_tokens_per_s": m["decode_tokens_per_s"],
           "draft_ms_per_round": draft_ms, "verify_ms_per_round": verify_ms,
           "prefix_hits": m["prefix_hits"], "prefix_blocks_at_end": cached,
           "wall_s": wall, "card": smi}
    log(f"serve gpt_125m speculative (gamma 4, 2-layer draft, kernel): "
        f"{len(prompts)} requests done, acceptance "
        f"{rec['acceptance_rate']:.4f}, {n_rounds} rounds, "
        f"{rec['tokens_per_round']:.2f} tokens a round "
        f"({rec['tokens_per_slot_round']:.2f} a slot-round), "
        f"round_ms={rec['round_ms']:.3f} "
        f"decode_tok_s={rec['decode_tokens_per_s']:.1f}, draft "
        f"{draft_ms:.3f} ms + verify {verify_ms:.3f} ms a round (host "
        f"clock), launches={launches} ({cfg.num_layers}/forward x "
        f"{n_rounds} rounds + {prefills} prefills), no block leaked "
        f"[{smi}]")
    return rec, handles, window, prefill


def profile_spec_round(model, prompts, smi):
    """Four profiled speculative rounds of a full 8-slot engine."""
    from paddle_tpu_torch.serving import SpeculativeEngine
    eng = SpeculativeEngine(model, device=model.device, **SPEC)
    for s, p in enumerate(prompts):
        eng.prefill(s, p)
    rec = profile_steps(eng.decode_many, 4)
    rec.update(slots=len(prompts),
               positions=[int(x) for x in eng.slot_positions()])
    log_profile("speculative round", rec, smi)
    return rec


def compare_spec(model, prompts, streams, steps=32):
    """Phase 10: the speculative streams against a one-token engine's,
    token by token; a slot's comparison stops at the first step whose
    one-token top-2 gap is below GAP_MIN (the verify's matmuls run at
    slots x 5 rows and the window takes the window kernel, so a near-tie may
    flip). Returns (compared tokens, tokens dropped by the rule)."""
    from paddle_tpu_torch.serving import PagedGenerationEngine
    eng = PagedGenerationEngine(
        model, slots=len(prompts), max_len=1024, block_size=16,
        attention_impl="kernel", capture_logits=True, device=model.device)
    gaps = [[] for _ in prompts]
    sel = eng._select

    def cap_select(logits, slot):
        gaps[slot].append(float(top2_gaps(logits.float().cpu())[0]))
        return sel(logits, slot)
    eng._select = cap_select
    toks = [[eng.prefill(s, p)] for s, p in enumerate(prompts)]
    for _ in range(steps - 1):
        out = eng.decode()
        for s, g in enumerate(top2_gaps(eng.last_logits)):
            gaps[s].append(float(g))
            toks[s].append(int(out[s]))
    compared = dropped = 0
    for s, spec in enumerate(streams):
        for t in range(steps):
            if gaps[s][t] < GAP_MIN:
                dropped += steps - t
                break
            if spec[t] != toks[s][t]:
                raise AssertionError(
                    f"phase 10: slot {s} token {t}: speculative "
                    f"{spec[t]} != one-token {toks[s][t]} (gap "
                    f"{gaps[s][t]:.3e})")
            compared += 1
    return compared, dropped


def quant_weights_quality(model, prompts, smi, steps=16):
    """Phase 11: int8 decode weights teacher-forced against the float
    engine (both fed the float engine's token each step), and the device
    time of one decode forward's dequant."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving import PagedGenerationEngine
    kw = dict(slots=len(prompts), max_len=1024, block_size=16,
              attention_impl="kernel", capture_logits=True,
              device=model.device)
    fl = PagedGenerationEngine(model, **kw)
    q8 = PagedGenerationEngine(model, weight_dtype="int8", **kw)
    for s, p in enumerate(prompts):
        q8.prefill(s, p)
        q8.set_slot_token(s, fl.prefill(s, p))
    matches, kls, t_fl, t_q8, flips = [], [], [], [], []
    dropped = 0
    for step in range(steps):
        t0 = time.perf_counter()
        toks = fl.decode()
        t_fl.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        q8.decode()
        t_q8.append(time.perf_counter() - t0)
        lo = fl.last_logits.astype(np.float64)
        lq = q8.last_logits.astype(np.float64)
        gaps = top2_gaps(lo)
        keep = gaps >= GAP_MIN
        dropped += int((~keep).sum())
        ao, aq = lo.argmax(-1), lq.argmax(-1)
        matches.extend((ao == aq)[keep].tolist())
        # each counted flip: the float gap, and how far below its own best
        # the int8 engine rates the float engine's pick
        flips.extend({"step": step, "slot": s, "float_gap": float(gaps[s]),
                      "int8_deficit": float(lq[s, aq[s]] - lq[s, ao[s]])}
                     for s in range(len(prompts))
                     if keep[s] and ao[s] != aq[s])
        po = np.exp(lo - lo.max(-1, keepdims=True))
        po /= po.sum(-1, keepdims=True)
        zq = lq - lq.max(-1, keepdims=True)
        log_q = zq - np.log(np.exp(zq).sum(-1, keepdims=True))
        kls.extend((po * (np.log(po + 1e-30) - log_q)).sum(-1).tolist())
        for s in range(len(prompts)):
            q8.set_slot_token(s, int(toks[s]))
    match, kl = float(np.mean(matches)), float(np.mean(kls))
    n_q = sum(1 for v in q8._decode_params.values() if isinstance(v, dict))
    n_w = sum(v["q"].numel() for v in q8._decode_params.values()
              if isinstance(v, dict))
    dequant_ms = time_ms(lambda: q8._dequant_params(q8._decode_params),
                         lambda: None, iters=10)
    # the dequant's least time: read each int8 code and f32 scale once,
    # write each f32 weight once
    dequant_bound = n_w * (1 + 4) / HBM_BYTES_PER_S * 1e3
    rec = {"slots": len(prompts), "steps": steps, "greedy_match": match,
           "compared": len(matches), "dropped_near_ties": dropped,
           "flips": flips,
           "logit_kl": kl, "gate": {"match": QUANT_MATCH, "kl": QUANT_KL},
           "decode_step_ms_float": 1e3 * sum(t_fl) / steps,
           "decode_step_ms_int8": 1e3 * sum(t_q8) / steps,
           "quantized_tensors": n_q, "quantized_weights": n_w,
           "dequant_ms": dequant_ms, "dequant_bound_ms": dequant_bound,
           "card": smi}
    log(f"int8 decode weights vs float (teacher-forced, {len(prompts)} "
        f"slots x {steps} steps): greedy match {match:.4f} over "
        f"{len(matches)} decisions ({dropped} near-ties < {GAP_MIN} "
        f"dropped; flips {flips}), mean KL {kl:.3e}; decode step "
        f"{rec['decode_step_ms_float']:.3f} ms float, "
        f"{rec['decode_step_ms_int8']:.3f} ms int8 weights; per-forward "
        f"dequant of {n_q} tensors ({n_w} weights) {dequant_ms:.4f} ms "
        f"device (bound {dequant_bound:.4f}) [{smi}]")
    if not (match >= QUANT_MATCH and kl < QUANT_KL):
        raise AssertionError(f"phase 11: int8 weights fail the quality "
                             f"gate (match {match}, KL {kl})")
    del fl, q8
    torch.cuda.empty_cache()
    return rec


def spec_int8_agreement(model, prompts, smi, n=8):
    """Phase 11: speculative decode with int8 weights and KV against the
    one-token int8 engine over the first n tokens of each request."""
    from paddle_tpu_torch.serving import (PagedGenerationEngine,
                                          SpeculativeEngine)
    kw = dict(weight_dtype="int8", kv_dtype="int8", device=model.device)
    spec, _, _ = serve(SpeculativeEngine(model, **SPEC, **kw), prompts, n)
    one, _, _ = serve(PagedGenerationEngine(
        model, slots=8, max_len=1024, block_size=16,
        attention_impl="kernel", **kw), prompts, n)
    same = [a == b for hs, ho in zip(spec, one)
            for a, b in zip(hs.tokens, ho.tokens)]
    agree = sum(same) / len(same)
    log(f"speculative x int8 weights and KV vs one-token int8: "
        f"{len(prompts)} requests, agreement {agree:.4f} over the first "
        f"{n} tokens (bar {SPEC_AGREE}) [{smi}]")
    if agree < SPEC_AGREE:
        raise AssertionError(f"phase 11: spec x int8 agrees {agree}")
    return {"requests": len(prompts), "tokens": n, "agreement": agree}


def hot_swap(model, prompts, want, smi):
    """Phase 11: phase 10's serving again, with a swap to a cloned param
    dict before step 3 and a swap with one wrong-shaped tensor before
    step 6: every stream must equal phase 10's, the first swap apply and
    the second be refused."""
    import torch
    from paddle_tpu_torch.serving import Scheduler, SpeculativeEngine
    eng = SpeculativeEngine(model, device=model.device, **SPEC)
    sched = Scheduler(eng, max_queue=64, device=model.device)
    handles = [sched.submit(p, max_new_tokens=32) for p in prompts]
    clone = {k: v.detach().clone() for k, v in eng._params.items()}
    bad = dict(clone)
    bad["blocks.0.attn.qkv.weight"] = torch.zeros((3, 3),
                                                  device=model.device)
    plan = {3: (clone, 1), 6: (bad, 2)}
    events = []
    while True:
        if sched._steps in plan:
            events.append(sched.schedule_weight_swap(*plan[sched._steps]))
        if not sched.step():
            break
    results = [ev.swap_result for ev in events]
    if [r["ok"] for r in results] != [True, False] or \
            sched.model_version != 1:
        raise AssertionError(f"phase 11: swap results {results}")
    inflight = results[0]["inflight"]
    for h, w in zip(handles, want):
        if h.status != "DONE" or h.tokens != w.tokens:
            raise AssertionError(
                f"phase 11: request {h.request_id} changed under the "
                f"swaps: {h.tokens} != {w.tokens}")
    log(f"hot-swap during speculative serving: clone applied with "
        f"{inflight} requests in flight ({results[0]['params']} tensors), "
        f"wrong shape refused ({results[1]['error'][:60]}...), "
        f"{len(prompts)} streams unchanged [{smi}]")
    return {"results": results, "streams_unchanged": len(prompts)}


# ------------------------------------------------------------ flash kernels
FLASH_CASES = [
    # name, shape, dtype, causal, mask, dropout rate
    ("a_train_bf16_causal", dict(B=8, H=16, Hk=16, S=1024, D=64), "bf16",
     True, False, 0.0),
    ("b_f32_causal_S1024", dict(B=2, H=8, Hk=8, S=1024, D=64), "f32", True,
     False, 0.0),
    ("c_f32_noncausal", dict(B=2, H=4, Hk=4, S=512, D=64), "f32", False,
     False, 0.0),
    ("d_ragged_S200", dict(B=2, H=4, Hk=4, S=200, D=64), "f32", True, False,
     0.0),
    ("e_D128_f32", dict(B=1, H=4, Hk=4, S=384, D=128), "f32", True, False,
     0.0),
    ("e_D128_bf16", dict(B=2, H=4, Hk=4, S=512, D=128), "bf16", True, False,
     0.0),
    ("f_mask_b1ss", dict(B=2, H=4, Hk=4, S=256, D=64), "f32", False, True,
     0.0),
    ("g_dropout_0.1", dict(B=2, H=4, Hk=4, S=512, D=64), "f32", True, False,
     0.1),
    ("h_gqa_16_4", dict(B=1, H=16, Hk=4, S=512, D=64), "f32", True, False,
     0.0),
    # the same options through the bf16 (tensor-core) builds
    ("d_ragged_S200_bf16", dict(B=2, H=4, Hk=4, S=200, D=64), "bf16", True,
     False, 0.0),
    ("f_mask_b1ss_bf16", dict(B=2, H=4, Hk=4, S=256, D=64), "bf16", False,
     True, 0.0),
    ("g_dropout_0.1_bf16", dict(B=2, H=4, Hk=4, S=512, D=64), "bf16", True,
     False, 0.1),
    ("h_gqa_16_4_bf16", dict(B=1, H=16, Hk=4, S=512, D=64), "bf16", True,
     False, 0.0),
    # the edges of the bf16 kernels' 128-row tiles and 64-column panels
    ("i_S64_bf16", dict(B=2, H=4, Hk=4, S=64, D=64), "bf16", True, False,
     0.0),
    ("j_S129_bf16", dict(B=2, H=4, Hk=4, S=129, D=64), "bf16", True, False,
     0.0),
    ("k_S1000_bf16", dict(B=1, H=8, Hk=8, S=1000, D=64), "bf16", True,
     False, 0.0),
    ("l_noncausal_S1024_bf16", dict(B=1, H=8, Hk=8, S=1024, D=64), "bf16",
     False, False, 0.0),
    ("m_D128_S1024_bf16", dict(B=1, H=8, Hk=8, S=1024, D=128), "bf16", True,
     False, 0.0),
    ("n_gqa_16_4_S200_bf16", dict(B=1, H=16, Hk=4, S=200, D=64), "bf16",
     True, False, 0.0),
]
MASKED_ROWS = (3, 100)      # rows the (B,1,S,S) mask of case f removes


def flash_case(seed, B, H, Hk, S, D, kind, causal, mask, rate):
    """Flattened [B*H, S, D] inputs as the autograd wrapper hands them to
    the kernels, the Meta, and the mask flattened to [B, S, S]."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = torch.bfloat16 if kind == "bf16" else torch.float32

    def rnd(rows):
        return torch.randn((rows, S, D), generator=g, device="cuda").to(dt)
    c = {"q": rnd(B * H), "k": rnd(B * Hk), "v": rnd(B * Hk),
         "do": rnd(B * H), "mask": None}
    if mask:
        m = torch.randn((B, S, S), generator=g, device="cuda") * 2
        m[torch.rand((B, S, S), generator=g, device="cuda") < 0.2] = \
            float("-inf")
        m[:, list(MASKED_ROWS), :] = float("-inf")
        c["mask"] = m
    c["meta"] = fa.Meta(H=H, Hk=Hk, Bm=B if mask else 1, causal=causal,
                        scale=D ** -0.5, rate=rate, seed=seed)
    return c


def flash_bound(B, H, Hk, S, D, kind, causal, which):
    """Least time of one kernel call on an H100: each input read once and
    each output written once over 3.35 TB/s, against the products over the
    (query, key) pairs the call needs (the lower triangle when causal): 2*D
    flops a pair and head per product, 2 products in the forward, 3 in dq,
    4 in dkv, at the rate of the input type."""
    el = 2 if kind == "bf16" else 4
    qo = B * H * S * D * el                  # q, dO, O, dQ, dK, dV per head
    kv = B * Hk * S * D * el
    rows = B * H * S * 4                     # lse / delta, f32
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    nbytes, products = {
        "fwd": (qo + 2 * kv + qo + rows, 2),
        "dq": (2 * qo + 2 * kv + 2 * rows + qo, 3),
        "dkv": (2 * qo + 2 * kv + 2 * rows + 2 * qo, 4)}[which]
    flops = products * 2 * D * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S[kind] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def run_flash_cases(flush, keep_going=False):
    """Phase 7. Each kernel is held against its plain version on the same
    inputs (the backward kernels get the plain forward's lse and delta).
    Returns (per-case records, timing record at the training shape,
    failures). Without `keep_going` the first failure raises; with it,
    every case runs and the failures are returned."""
    results, timing, failures = [], None, []
    for i, case in enumerate(FLASH_CASES):
        try:
            rec, t = flash_case_check(i, *case, flush=flush)
        except Exception as e:       # noqa: BLE001 - reported, then raised
            if not keep_going:
                raise
            failures.append(f"{case[0]}: {type(e).__name__}: {e}")
            log(f"flash {case[0]}: FAILED {type(e).__name__}: {e}")
            continue
        results.append(rec)
        timing = timing or t
    return results, timing, failures


def flash_case_check(i, name, shp, kind, causal, mask, rate, flush):
    """One phase-7 case; the first case is also timed (phase 7a)."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    c = flash_case(200 + i, **shp, kind=kind, causal=causal, mask=mask,
                   rate=rate)
    q, k, v, do, mf, meta = (c[n] for n in ("q", "k", "v", "do", "mask",
                                            "meta"))
    o, lse = fa.flash_fwd(q, k, v, mf, meta)
    po, plse = fa.fwd_plain(q, k, v, mf, meta)
    delta = (do.float() * po.float()).sum(-1)
    dq = fa.flash_dq(q, k, v, do, plse, delta, mf, meta)
    pdq = fa.dq_plain(q, k, v, do, plse, delta, mf, meta)
    dk, dv = fa.flash_dkv(q, k, v, do, plse, delta, mf, meta)
    pdk, pdv = fa.dkv_plain(q, k, v, do, plse, delta, mf, meta)
    dq2 = fa.flash_dq(q, k, v, do, plse, delta, mf, meta)
    dk2, dv2 = fa.flash_dkv(q, k, v, do, plse, delta, mf, meta)
    torch.cuda.synchronize()
    # the backward kernels use no atomics: a second launch repeats the
    # first bit for bit
    for out, a, b in (("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2)):
        if not torch.equal(a, b):
            raise AssertionError(f"flash {name}: {out} differs between two "
                                 "launches on the same inputs")
    tol = BF16_TOL if kind == "bf16" else ATOL
    errs, wrong = {}, []
    for out, got, want, t in (("o", o, po, tol), ("lse", lse, plse, ATOL),
                              ("dq", dq, pdq, tol), ("dk", dk, pdk, tol),
                              ("dv", dv, pdv, tol)):
        err = (got.float() - want.float()).abs()
        bad = (err > t + t * want.float().abs()) | ~torch.isfinite(got)
        errs[out] = float(err.max())
        if bool(bad.any()):
            wrong.append(f"{out} (max_abs_err={errs[out]}, tol {t}, "
                         f"{int(bad.sum())} bad, first at "
                         f"{bad.nonzero()[:4].tolist()})")
    if wrong:
        raise AssertionError(f"flash {name}: kernel disagrees with the "
                             "plain version in " + "; ".join(wrong))
    if mask:
        rows = o.reshape(shp["B"], shp["H"], shp["S"], -1)[
            :, :, list(MASKED_ROWS)]
        if bool((rows != 0).any()):
            raise AssertionError(f"flash {name}: fully masked rows "
                                 "must be exact zeros")
    rec = {"case": name, **shp, "kind": kind, "causal": causal,
           "mask": mask, "dropout": rate, "tol": tol,
           "max_abs_err": errs}
    log(f"flash {name}: B={shp['B']} H={shp['H']} Hk={shp['Hk']} "
        f"S={shp['S']} D={shp['D']} {kind} causal={causal} mask={mask} "
        f"dropout={rate} max_abs_err "
        + " ".join(f"{n}={e:.2e}" for n, e in errs.items())
        + f" (tol {tol})")
    timing = (time_flash(c, shp, kind, causal, plse, delta, flush)
              if i == 0 else None)
    return rec, timing


def time_flash(c, shp, kind, causal, lse, delta, flush):
    """Device ms of each kernel, its plain version, the SDPA yardsticks
    and the bounds at the training shape (phase 7a)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do, meta = (c[n] for n in ("q", "k", "v", "do", "meta"))
    B, H, S, D = shp["B"], shp["H"], shp["S"], shp["D"]
    fns = {
        "fwd": (lambda: fa.flash_fwd(q, k, v, None, meta),
                lambda: fa.fwd_plain(q, k, v, None, meta)),
        "dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, None, meta),
               lambda: fa.dq_plain(q, k, v, do, lse, delta, None, meta)),
        "dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, None, meta),
                lambda: fa.dkv_plain(q, k, v, do, lse, delta, None, meta)),
    }
    q4, k4, v4, do4 = (t.reshape(B, -1, S, D) for t in (q, k, v, do))
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q4, k4, v4))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        torch.autograd.backward(out, do4)
    lib_fwd = time_ms(sdpa_fwd, flush)
    lib_bwd = time_ms(sdpa_fwd_bwd, flush) - lib_fwd
    out = {"sdpa_fwd_ms": lib_fwd, "sdpa_bwd_ms": lib_bwd}
    for which, (kern, plain) in fns.items():
        bound, by, nbytes, flops = flash_bound(B, H, shp["Hk"], S, D, kind,
                                               causal, which)
        kms = time_ms(kern, flush)
        pms = time_ms(plain, flush, iters=5)
        lib = lib_fwd if which == "fwd" else lib_bwd
        out[which] = {"ms": kms, "plain_ms": pms, "bound_ms": bound,
                      "bound_by": by, "bytes": nbytes, "flops": flops,
                      "tflops": flops / kms / 1e9, "library_ms": lib,
                      "x_library": kms / lib}
        log(f"flash {which} at B={B} H={H} S={S} D={D} {kind} causal: "
            f"kernel_ms={kms:.4f} ({flops / kms / 1e9:.1f} TFLOP/s) "
            f"plain_ms={pms:.4f} bound_ms={bound:.5f} ({by}) "
            f"sdpa_ms={lib:.4f} x_sdpa={kms / lib:.2f}")
    log(f"sdpa yardstick: forward {lib_fwd:.4f} ms, backward "
        f"{lib_bwd:.4f} ms (forward+backward minus forward)")
    return out


def wgmma_resources():
    """Registers and spills of the bf16 wgmma kernels, from the compiler's
    report (`build.ptxas_report`), with their dynamic shared memory."""
    import ctypes
    import re
    from paddle_tpu_torch._kernels import build
    from paddle_tpu_torch.ops import flash_attention as fa
    lib = fa._kernel_lib()
    lib.flash_attention_wgmma_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    out, kernel = [], None
    for line in build.ptxas_report("flash_attention").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1) if "wgmma" in m.group(1) else None
            spills = (None, None)
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            # the smem query's kernel index: fwd 0, dq 1, dkv 2
            which = (2 if "flash_dkv" in kernel else
                     1 if "flash_dq" in kernel else 0)
            D = 128 if "ILi128E" in kernel else 64
            out.append({"kernel": kernel, "D": D,
                        "general": "Lb1E" in kernel,
                        "registers": int(m.group(1)),
                        "spill_stores": spills[0], "spill_loads": spills[1],
                        "smem_dynamic":
                            lib.flash_attention_wgmma_smem(which, D),
                        "ptxas": line.strip()})
            kernel = None
    return out


# ------------------------------------------------------------------ training
TRAIN_350M = dict(vocab_size=50304, max_seq_len=1024, hidden=1024,
                  layers=24, heads=16)


# device kernels of a profiled training step, grouped by name
KERNEL_KINDS = (
    ("flash attention", ("flash_",)),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("layernorm", ("layer_norm",)),
    ("reduction", ("reduce",)),
    ("copy", ("copy", "cat", "index")),
    ("elementwise", ("elementwise",)),
)


def step_flops(cfg, n_params, B, S):
    """Operations of one training step: 6 per parameter and token (forward
    and backward products), plus the causal attention products: 2 of
    2*hidden flops per (query, key) pair and layer in the forward, twice
    that again in the backward."""
    pairs = B * S * (S + 1) // 2
    return 6 * n_params * B * S + 12 * cfg.layers * cfg.hidden * pairs


def time_step_parts(cfg, step_fn, params, state, toks, labs):
    """Device ms of the flagship step and of its parts, by CUDA events:
    the whole step, forward + backward of the loss (so clip + AdamW is the
    difference), the forward alone, and the LM head's logits product three
    ways: the port's `matmul_f32` (bf16 operands, f32 result) beside a
    bf16-result matmul and an f32-operand matmul, the two choices it
    avoids (timed only)."""
    import torch
    from paddle_tpu_torch.ops.flash_attention import flash_attention_bhsd
    from paddle_tpu_torch.ops.fused_ce import matmul_f32
    from paddle_tpu_torch.parallel import gpt_spmd

    def no_flush():
        pass

    def loss():
        return gpt_spmd._loss(params, toks, labs, cfg, flash_attention_bhsd)

    def fwd():
        with torch.no_grad():
            loss()

    def fwd_bwd():
        loss().backward()
        for p in params.values():
            p.grad = None

    out = {"step_ms": time_ms(lambda: step_fn(params, state, toks, labs),
                              no_flush, iters=5, warmup=1),
           "fwd_bwd_ms": time_ms(fwd_bwd, no_flush, iters=5, warmup=1),
           "fwd_ms": time_ms(fwd, no_flush, iters=5, warmup=1)}
    out["clip_adamw_ms"] = out["step_ms"] - out["fwd_bwd_ms"]
    T = toks.numel()
    g = torch.Generator(device="cuda").manual_seed(5)
    h = torch.randn((T, cfg.hidden), generator=g, device="cuda").to(
        params["wte"].dtype)
    wte = params["wte"].detach()
    wt = wte.t()
    out["lm_head"] = {
        "tokens": T, "vocab": cfg.vocab_size,
        "flops": 2 * T * cfg.hidden * cfg.vocab_size,
        "matmul_f32_ms": time_ms(lambda: matmul_f32(h, wt), no_flush),
        "bf16_result_ms": time_ms(lambda: torch.matmul(h, wt), no_flush),
        "f32_operands_ms": time_ms(
            lambda: torch.matmul(h.float(), wte.float().t()), no_flush,
            iters=5)}
    log(f"step parts (device ms): step {out['step_ms']:.2f}, forward + "
        f"backward {out['fwd_bwd_ms']:.2f}, forward {out['fwd_ms']:.2f}, "
        f"clip + AdamW {out['clip_adamw_ms']:.2f}")
    lm = out["lm_head"]
    log(f"LM head logits ({T} x {cfg.hidden} x {cfg.vocab_size}): "
        f"matmul_f32 {lm['matmul_f32_ms']:.3f} ms, bf16 result "
        f"{lm['bf16_result_ms']:.3f} ms, f32 operands "
        f"{lm['f32_operands_ms']:.3f} ms")
    return out


def train_step_350m(smi, warmup=3, steps=10, B=8):
    """Phase 8: the flagship step through `make_train_step`."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import GPTSpmdConfig, make_train_step
    cfg = GPTSpmdConfig(**TRAIN_350M, param_dtype="bfloat16",
                        compute_dtype="bfloat16", remat=False)
    S = cfg.max_seq_len
    step_fn, init_fn = make_train_step(cfg, learning_rate=2e-4,
                                       device="cuda")
    params, state = init_fn(0)
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    labs = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    losses = []
    for _ in range(warmup):
        loss, params, state = step_fn(params, state, toks, labs)
        losses.append(float(loss))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, params, state = step_fn(params, state, toks, labs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = {"fwd": fa.launches_fwd, "dq": fa.launches_dq,
                "dkv": fa.launches_dkv}
    peak = torch.cuda.max_memory_allocated()
    for which, n in launches.items():
        if n != steps * cfg.layers:
            raise AssertionError(f"phase 8: {n} flash {which} launches in "
                                 f"{steps} steps, want {cfg.layers} a step")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 8: loss not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"phase 8: loss did not fall: {losses}")
    step_ms = sorted(times)[len(times) // 2] * 1e3
    mean_ms = sum(times) / len(times) * 1e3
    flops = step_flops(cfg, n_params, B, S)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, state, toks, labs)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    by_kind = {}
    for e in kernels:
        kind = next((k for k, keys in KERNEL_KINDS if any(
            x in e.key.lower() for x in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + dev_us(e) / 1e3
    rec = {"config": "gpt-350m", **TRAIN_350M, "B": B, "S": S,
           "dtype": "bfloat16", "remat": False, "lr": 2e-4,
           "n_params": n_params, "losses": losses,
           "step_ms_median": step_ms, "step_ms_mean": mean_ms,
           "step_ms_all": [t * 1e3 for t in times],
           "tokens_per_s": B * S / (step_ms / 1e3),
           "peak_memory_gb": peak / 1e9, "flops_per_step": flops,
           "mfu": flops / (step_ms / 1e3) / BF16_PEAK,
           "peak_bound_ms": flops / BF16_PEAK * 1e3,
           "launches": launches, "traced_step_ms": traced_ms,
           "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / traced_ms if busy_ms else None,
           "device_idle_share_untraced": (1 - busy_ms / step_ms
                                          if busy_ms else None),
           "kernels_per_step": sum(e.count for e in kernels),
           "device_ms_by_kind": by_kind,
           "top": [{"name": e.key[:70], "ms": dev_us(e) / 1e3,
                    "count": e.count} for e in top], "card": smi}
    log(f"train gpt-350m bf16 B={B} S={S}: step {step_ms:.2f} ms median "
        f"({mean_ms:.2f} mean), {rec['tokens_per_s']:.0f} tokens/s, peak "
        f"memory {rec['peak_memory_gb']:.2f} GB, {flops:.3e} flops/step, "
        f"MFU {rec['mfu']:.4f} (peak-bound step "
        f"{rec['peak_bound_ms']:.2f} ms), launches/step "
        f"{launches['fwd'] // steps}+{launches['dq'] // steps}+"
        f"{launches['dkv'] // steps}, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} [{smi}]")
    log(f"profile train step: {traced_ms:.2f} ms traced, device busy "
        f"{busy_ms:.2f} ms, idle share {rec['device_idle_share']} of the "
        f"traced step, {rec['device_idle_share_untraced']} of the untraced "
        f"median, {rec['kernels_per_step']} kernels")
    log("  by kind: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in sorted(by_kind.items(),
                                              key=lambda kv: -kv[1])))
    for t in rec["top"]:
        log(f"  {t['ms']:.3f} ms x{t['count']} {t['name']}")
    rec["parts"] = time_step_parts(cfg, step_fn, params, state, toks, labs)
    return rec


def compare_train_paths(steps=3, B=2):
    """Phase 9: flash kernels + remat + fused CE against dense attention +
    no remat + unfused CE, f32 (TF32 off), depth 2 at full width, the same
    weights and batch."""
    import dataclasses
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import GPTSpmdConfig, make_train_step
    cfg_k = GPTSpmdConfig(**{**TRAIN_350M, "layers": 2}, remat=True,
                          fused_ce_chunks=8)
    cfg_p = dataclasses.replace(cfg_k, remat=False, fused_ce_chunks=0)
    S = cfg_k.max_seq_len
    rng = np.random.RandomState(1)
    toks = torch.from_numpy(rng.randint(0, cfg_k.vocab_size, (B, S))).cuda()
    labs = torch.from_numpy(rng.randint(0, cfg_k.vocab_size, (B, S))).cuda()
    runs = {}
    for name, cfg in (("kernel", cfg_k), ("plain", cfg_p)):
        step_fn, init_fn = make_train_step(cfg, learning_rate=2e-4,
                                           device="cuda", attention=name)
        params, state = init_fn(0)
        p0 = {n: t.detach().clone() for n, t in params.items()}
        fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
        losses = []
        for _ in range(steps):
            loss, params, state = step_fn(params, state, toks, labs)
            losses.append(float(loss))
        runs[name] = (losses, params, (fa.launches_fwd, fa.launches_dq,
                                       fa.launches_dkv), p0)
    (lk, pk, nk, p0), (lp, pp, npl, p0p) = runs["kernel"], runs["plain"]
    if not all(torch.equal(p0[n], p0p[n]) for n in p0):
        raise AssertionError("phase 9: the two paths started apart")
    # remat recomputes each block's forward in the backward
    if nk != (2 * steps * 2, steps * 2, steps * 2) or npl != (0, 0, 0):
        raise AssertionError(f"phase 9 launches kernel {nk} plain {npl}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    leaf_err = {n: float((pk[n] - pp[n]).detach().abs().max()) for n in pk}
    upd_err = {n: float((pk[n] - pp[n]).detach().norm()
                        / (pp[n] - p0[n]).detach().norm()) for n in pk}
    worst = max(leaf_err, key=leaf_err.get)
    worst_upd = max(upd_err, key=upd_err.get)
    param_err, update_err = leaf_err[worst], upd_err[worst_upd]
    rec = {"layers": 2, "B": B, "S": S, "steps": steps, "dtype": "float32",
           "losses_kernel": lk, "losses_plain": lp,
           "loss_max_rel_err": loss_err, "param_max_abs_err": param_err,
           "param_max_abs_err_by_leaf": leaf_err,
           "update_rel_err_by_leaf": upd_err,
           "tol": {"loss_rtol": TRAIN_LOSS_RTOL,
                   "param_atol": TRAIN_PARAM_ATOL,
                   "update_rtol": TRAIN_UPDATE_RTOL},
           "launches_kernel_path": nk}
    log(f"parity train kernel vs plain path (hidden 1024, 2 layers, f32, "
        f"B={B}, {steps} steps): losses {[round(x, 6) for x in lk]} vs "
        f"{[round(x, 6) for x in lp]}, max rel err {loss_err:.2e} (tol "
        f"{TRAIN_LOSS_RTOL}), params max abs err {param_err:.2e} in {worst} "
        f"(tol {TRAIN_PARAM_ATOL}), update rel err {update_err:.2e} in "
        f"{worst_upd} (tol {TRAIN_UPDATE_RTOL}), kernel launches {nk}")
    if not (loss_err <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_ATOL
            and update_err <= TRAIN_UPDATE_RTOL):
        raise AssertionError("phase 9: kernel and plain training paths "
                             "disagree")
    return rec


def main(argv):
    flash_only = "--flash-only" in argv
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
    for name in sorted(libs):
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}:", line.strip())
    report["wgmma_resources"] = wgmma_resources()
    for r in report["wgmma_resources"]:
        log(f"wgmma kernel {r['kernel']} (D={r['D']}, "
            f"{'mask/dropout' if r['general'] else 'plain'} build): "
            f"{r['registers']} registers, "
            f"{r['spill_stores']} B spill stores, {r['spill_loads']} B "
            f"spill loads, {r['smem_dynamic']} B dynamic shared memory")
    if flash_only:
        # the flash kernels alone, every case run and reported
        flush_buf = torch.empty(64 * 1024 * 1024, device="cuda")
        _, _, failures = run_flash_cases(lambda: _flush_l2(flush_buf),
                                         keep_going=True)
        log(f"flash-only: {len(FLASH_CASES) - len(failures)} of "
            f"{len(FLASH_CASES)} cases agree [{smi}]")
        return 1 if failures else 0

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
    pa.launches = pa.launches_window = pa.launches_prefill = 0
    handles, m, wall = serve(engine, prompts, max_new=32)
    launches, prefill4 = pa.launches, pa.launches_prefill
    prefills = len(prompts) + m["requests"]["preempted"]
    if launches <= 0:
        raise AssertionError("the server never launched the kernel")
    if launches != cfg.num_layers * (m["decode_steps"] + prefills) or \
            prefill4 != cfg.num_layers * prefills or pa.launches_window:
        raise AssertionError(
            f"{launches} launches ({prefill4} on the tile path, "
            f"{pa.launches_window} on the window path), want "
            f"{cfg.num_layers} per forward over {m['decode_steps']} decode "
            f"steps + {prefills} prefills (tiles)")
    if m["prefix_hits"] < 1:
        raise AssertionError("no prefix-cache hit on shared prompts")
    ttfts = [h.ttft_s for h in handles]
    serve_rec = {"requests": len(prompts), "max_new_tokens": 32,
                 "kernel_launches": launches,
                 "kernel_launches_prefill": prefill4,
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
    pa.launches = pa.launches_prefill = 0
    _, m8, wall8 = serve(eng8, prompts[8:12], max_new=32)
    launches8 = pa.launches - pa.launches_prefill   # the decode launches
    if launches8 <= 0:
        raise AssertionError("the int8 server never launched the kernel")
    report["serve_int8"] = {"requests": 4, "kernel_launches": pa.launches,
                            "kernel_launches_decode": launches8,
                            "decode_step_ms": m8["decode_step_ms"],
                            "wall_s": wall8}
    log(f"serve gpt_125m int8 KV: 4 requests done, launches={pa.launches} "
        f"({launches8} decode) "
        f"decode_step_ms={m8['decode_step_ms']:.3f} [{smi}]")
    del eng8, engine

    # where a decode step's time goes ------------------------------------------------
    prof = profile_decode(model, prompts[8:16])
    report["profile"] = prof
    log_profile("one-token decode step", prof, smi)

    # 6. kernel path vs plain path ------------------------------------------------
    compared, dropped = compare_paths(model, prompts[:4] + prompts[8:12])
    report["parity"] = {"compared_steps": compared,
                        "dropped_near_ties": dropped, "gap_min": GAP_MIN}
    log(f"parity kernel vs plain path: {compared} slot-steps agree, "
        f"{dropped} dropped by the top-2 gap < {GAP_MIN} rule")
    if compared == 0:
        raise AssertionError("phase 6 compared nothing")

    # 7. flash kernels vs plain -------------------------------------------------
    flush_buf = torch.empty(64 * 1024 * 1024, device="cuda")
    flash_cases, flash_t, _ = run_flash_cases(lambda: _flush_l2(flush_buf))
    report["flash_cases"], report["flash_timing"] = flash_cases, flash_t
    del flush_buf

    # 8. the training step ---------------------------------------------------------
    del model
    torch.cuda.empty_cache()
    report["train"] = train_step_350m(smi)
    torch.cuda.empty_cache()

    # 9. training kernel path vs plain path ------------------------------------------
    report["train_parity"] = compare_train_paths()
    torch.cuda.empty_cache()

    # 10. the speculative server ----------------------------------------------
    model = gpt_125m(device="cuda", seed=0)
    spec_rec, spec_handles, window10, prefill10 = serve_spec(model,
                                                             prompts, smi)
    report["serve_spec"] = spec_rec
    spec_rec["profile"] = profile_spec_round(model, prompts[8:16], smi)
    log(f"device busy a speculative round "
        f"{spec_rec['profile']['device_busy_ms_per_step']:.3f} ms (the "
        f"paged kernel {spec_rec['profile']['paged_ms_per_step']:.4f} ms) "
        f"vs a one-token step {prof['device_busy_ms_per_step']:.3f} ms")
    picks = list(range(4)) + list(range(8, 12))
    compared, dropped = compare_spec(model, [prompts[i] for i in picks],
                                     [spec_handles[i].tokens for i in picks])
    spec_rec["parity"] = {"compared_tokens": compared,
                          "dropped_near_ties": dropped, "gap_min": GAP_MIN}
    log(f"parity speculative vs one-token: {compared} tokens agree, "
        f"{dropped} dropped by the top-2 gap < {GAP_MIN} rule")
    if compared == 0:
        raise AssertionError("phase 10 compared nothing")

    # 11. int8 decode weights, logit capture and hot-swap ---------------------
    report["quant_weights"] = quant_weights_quality(model, prompts[8:16], smi)
    report["spec_int8"] = spec_int8_agreement(model, prompts[8:12], smi)
    report["hot_swap"] = hot_swap(model, prompts, spec_handles, smi)

    # summary ------------------------------------------------------------------------
    dec = next(c for c in cases if c["case"] == "decode_f32")
    dec8 = next(c for c in cases if c["case"] == "decode_int8")
    win = next(c for c in cases if c["case"] == "verify_f32_T5")
    tile = next(c for c in cases if c["case"] == "prefill_f32_T512")
    err_w = max(c["max_abs_err"] for c in cases
                if c["kind"] == "f32" and 1 < c["T"] <= pa.WINDOW_ROWS)
    err_t = max(c["max_abs_err"] for c in cases
                if c["kind"] == "f32" and c["T"] > pa.WINDOW_ROWS)
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
    # the decode kernel's launches are phase 4's at T=1; the window
    # kernel's phase 10's verify windows; the tile kernel's the prefills of
    # phases 4 and 10
    kernels = {"kernels": [
        entry("paged_attention", "paddle_tpu/ops/pallas/paged_attention.py:75",
              launches - prefill4, dec, err_f),
        entry("paged_attention_int8",
              "paddle_tpu/ops/pallas/paged_attention.py:110", launches8, dec8,
              err_8),
        entry("paged_attention_window",
              "paddle_tpu/ops/pallas/paged_attention.py:75", window10, win,
              err_w),
        entry("paged_attention_prefill",
              "paddle_tpu/ops/pallas/paged_attention.py:75",
              prefill4 + prefill10, tile, err_t)]}
    flash_src = {"fwd": ("flash_attention_fwd", ("o", "lse"),
                         "paddle_tpu/ops/pallas/flash_attention.py:70"),
                 "dq": ("flash_attention_dq", ("dq",),
                        "paddle_tpu/ops/pallas/flash_attention.py:234"),
                 "dkv": ("flash_attention_dkv", ("dk", "dv"),
                         "paddle_tpu/ops/pallas/flash_attention.py:286")}
    for which, (name, outs, replaces) in flash_src.items():
        t = flash_t[which]
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces,
            "launches": report["train"]["launches"][which],
            "max_abs_err": max(c["max_abs_err"][o] for c in flash_cases
                               for o in outs),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
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
    sys.exit(main(sys.argv[1:]))
