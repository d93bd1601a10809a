#!/usr/bin/env python3
"""Sweep compile-time constants of the paged-attention kernels on one GPU.

    python3 sweep_paged.py kTileSplit=128,512 kTileStages=3 kSplit=64
    python3 sweep_paged.py --cases prefill_f32_T512,verify_f32_T5 \
        kTileKeys=32+kTileMinBlocks=3

Each variant changes one `constexpr int` of
`paddle_tpu_torch/csrc/paged_attention.cu` (or several, joined by `+`)
from its committed value. The
variants are built at once (one nvcc each, with the flags of
`paddle_tpu_torch._kernels.build`, into build/paddle_tpu_torch/sweep/),
then each case of chip_smoke.py's phase 3 (or those named by --cases) runs
on the committed build and on every variant, in turns (committed,
variants, committed): each variant's output must agree with the committed
build's (f32 and int8 at 1e-5, bf16 at 1e-2), and each is timed as phase 3
times it (CUDA events after an L2 flush). Prints the card's name and power
limit and one line a case; the detail goes to chiprun_out/sweep_paged.json.
Without CUDA it exits 2 and prints no result.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def parse(argv):
    """(case names or None, variants) from the command line; a variant
    is a tuple of (constant, value) pairs."""
    names, variants = None, []
    args = list(argv)
    while args:
        a = args.pop(0)
        if a == "--cases":
            names = set(args.pop(0).split(","))
            continue
        if "+" in a:        # one variant that changes several constants
            variants.append(tuple((k, int(v)) for k, _, v in
                                  (x.partition("=") for x in a.split("+"))))
            continue
        key, _, vals = a.partition("=")
        if not vals:
            raise SystemExit(f"sweep_paged: want NAME=V1,V2,... or "
                             f"NAME=V+NAME=V, got {a!r}")
        variants += [((key, int(v)),) for v in vals.split(",")]
    return names, variants


def build_variants(variants):
    """Build every variant at once; returns {tag: library path}."""
    from paddle_tpu_torch._kernels import build
    src_dir = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
    with open(os.path.join(src_dir, "paged_attention.cu")) as fh:
        text = fh.read()
    running = []
    for changes in variants:
        tag = "+".join(f"{key}={val}" for key, val in changes)
        variant = text
        for key, val in changes:
            pat = re.compile(rf"(constexpr int {key} = )\d+;")
            if not pat.search(text):
                raise SystemExit(f"sweep_paged: no `constexpr int {key}` in "
                                 "paged_attention.cu")
            variant = pat.sub(rf"\g<1>{val};", variant)
        d = os.path.join(build.build_dir(), "sweep", tag.replace("=", "_"))
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(src_dir):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(src_dir, f), d)
        src = os.path.join(d, "paged_attention.cu")
        with open(src, "w") as fh:
            fh.write(variant)
        out = os.path.join(d, "libpaged_attention.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", out, src]
        running.append((tag, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for tag, out, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"sweep_paged: nvcc failed for {tag}\n{log}")
        for line in log.splitlines():
            if "spill" in line and " 0 bytes spill stores" not in line:
                print(f"ptxas {tag}: {line.strip()}", flush=True)
        libs[tag] = out
    return libs


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("sweep_paged: CUDA is not available; this script runs only "
              "on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch.ops import paged_attention as pa
    names, variants = parse(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"committed": (pa._kernel_lib(), pa.decode_split_keys())}
    for tag, path in build_variants(variants).items():
        lib = pa.bind(ctypes.CDLL(path))
        libs[tag] = (lib, lib.paged_attention_decode_split())
    order = list(libs) + ["committed"]
    flush_buf = torch.empty(64 * 1024 * 1024, device="cuda")

    def flush():
        cs._flush_l2(flush_buf)
    report = {"card": smi, "variants": [t for t in libs], "cases": []}
    try:
        for i, (name, shape, kind) in enumerate(
                cs.paged_cases(pa.decode_split_keys())):
            if names is not None and name not in names:
                continue
            c = cs.paged_case(100 + i, shape["S"], shape["T"], shape["pos"],
                              bs=shape.get("bs", 16),
                              kind="f32" if kind == "nan" else kind,
                              all_nan=kind == "nan")
            scales = (dict(k_scale=c["ks"], v_scale=c["vs"])
                      if kind == "int8" else {})

            def call():
                return pa.paged_attention(c["q"], c["k"], c["v"],
                                          c["tables"], c["pos"], **scales)
            tol = cs.BF16_TOL if kind == "bf16" else cs.ATOL
            rec = {"case": name, "T": shape["T"], "kind": kind, "ms": {},
                   "max_abs_err": {}}
            want = None
            for tag in order:
                pa._lib, pa._split = libs[tag]
                got = call().float()
                torch.cuda.synchronize()
                if want is None:
                    want = got
                err = (got - want).abs()
                if not bool(torch.isfinite(got).all()) or \
                        bool((err > tol + tol * want.abs()).any()):
                    raise AssertionError(f"{name}: {tag} disagrees with the "
                                         "committed build")
                rec["max_abs_err"][tag] = float(err.max())
                rec["ms"].setdefault(tag, []).append(cs.time_ms(call, flush))
            report["cases"].append(rec)
            print(f"case {name}: " + "  ".join(
                f"{t} " + "/".join(f"{x:.4f}" for x in ms)
                for t, ms in rec["ms"].items()) + f" ms [{smi}]", flush=True)
    finally:
        pa._lib, pa._split = libs["committed"]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "sweep_paged.json"),
              "w") as fh:
        json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
