"""The host cost of the flash launches, in the tree this file lives in.

Since they became `torch.library` custom ops
(`paddle_tpu_torch/ops/flash_attention.py`), each call of `flash_fwd`,
`flash_dq` and `flash_dkv` goes through the dispatcher. This script reads
what that costs where it shows: the host us of one call of each op (the
card kept busy, so no call waits for it), `chip_smoke.py` phase 8's
GPT-350M bf16 training step (24 layers: 72 calls a step) and phase 22's
BERT-width encoder f32 step (12 layers: 36 calls a step), through the
tree's own `chip_smoke.py` functions.

Compare two trees on one card in one command: unpack the other tree with
`git archive` into `build/`, copy this file to its `tools/`, and run the
two in turns, e.g. parent, change, change, parent:

    python3 tools/flash_op_cost.py --label change

Prints one `flash_op_cost {json}` line. Needs CUDA; exits 2 without it.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def op_host_us(cs, iters=400):
    """Host us a call of each launch at a small bf16 shape."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((2, 128, 64), generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    meta = fa.Meta(H=2, Hk=2, causal=True, scale=0.125)
    o, lse = fa.flash_fwd(q, k, v, None, meta)
    delta = (do.float() * o.float()).sum(-1)
    calls = {"fwd": lambda: fa.flash_fwd(q, k, v, None, meta),
             "dq": lambda: fa.flash_dq(q, k, v, do, lse, delta, None, meta),
             "dkv": lambda: fa.flash_dkv(q, k, v, do, lse, delta, None,
                                         meta)}
    return {n: min(cs.host_us(fn, iters) for _ in range(5))
            for n, fn in calls.items()}


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("flash_op_cost: CUDA is not available", file=sys.stderr)
        return 2
    label = argv[argv.index("--label") + 1] if "--label" in argv else ROOT
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import paddle_tpu_torch as pt
    from paddle_tpu_torch._kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip().splitlines()[0]
    build.build_all()
    rec = {"label": label, "card": smi, "op_host_us": op_host_us(cs)}
    t0 = time.perf_counter()
    train = cs.train_step_350m(smi, warmup=3, steps=10)
    rec["phase8_step_ms_median"] = train["step_ms_median"]
    rec["phase8_step_ms_all"] = train["step_ms_all"]
    del train
    torch.cuda.empty_cache()
    pt.set_device("gpu")
    pt.seed(22)
    state = {k: v._data.detach().clone()
             for k, v in cs.nn_encoder(pt, 0.1).state_dict().items()}
    out_dir = os.path.join(ROOT, "build", "flash_op_cost")
    enc = cs.nn_train_arm(pt, smi, "f32", state, out_dir)
    rec["phase22_f32_step_ms_quartiles"] = enc["step_ms_quartiles"]
    rec["seconds"] = time.perf_counter() - t0
    print("flash_op_cost " + json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
