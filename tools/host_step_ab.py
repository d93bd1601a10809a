"""The host-bound ResNet-50 step, in the tree this file lives in.

`chip_smoke.py` phase 23's model (`_resnet_model`: ResNet-50, 10
classes, Momentum, f32 with TF32 off) takes `Model.train_batch` steps on
one fixed batch of 128 images at 3x32x32 on the card, with no
`DataLoader`: the step is the host's (3,362 kernel launches for about 18
ms of device time). Beside it, as a control for the host's own speed,
the microseconds of one `add` and one `mul` of a 4x4 CPU tensor, read
before the port is imported and after the steps.

Compare two trees on one card in one command: unpack the other tree with
`git archive` into `build/`, copy this file to its `tools/`, and run the
two in turns, each in a fresh process, e.g. change, parent, parent,
change, ...:

    python3 tools/host_step_ab.py --label change

Prints one `host_step_ab {json}` line. Needs CUDA; exits 2 without it.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, WARMUP, B = 30, 3, 128


def torch_op_us(torch):
    """The least mean µs of an add and a mul over 20 rounds of 200."""
    a = torch.randn(4, 4)
    best = float("inf")
    for _ in range(20):
        t = time.perf_counter()
        for _ in range(200):
            a.add(a).mul(a)
        best = min(best, (time.perf_counter() - t) / 200 * 1e6)
    return best


def main(argv):
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("host_step_ab: CUDA is not available", file=sys.stderr)
        return 2
    label = argv[argv.index("--label") + 1] if "--label" in argv else ROOT
    op_before = torch_op_us(torch)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import paddle_tpu_torch as pt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip().splitlines()[0]
    pt.set_device("gpu")
    model = cs._resnet_model(pt)
    rng = np.random.RandomState(0)
    x = rng.rand(B, 3, 32, 32).astype("float32")
    y = rng.randint(0, 10, (B, 1)).astype("int64")
    ms = []
    for _ in range(WARMUP + STEPS):
        t = time.perf_counter()
        model.train_batch([x], [y])
        ms.append((time.perf_counter() - t) * 1e3)
    ms = sorted(ms[WARMUP:])
    rec = {"label": label, "card": smi, "B": B, "steps": STEPS,
           "step_ms_quartiles": [ms[STEPS // 4], ms[STEPS // 2],
                                 ms[3 * STEPS // 4]],
           "torch_op_us_before": op_before,
           "torch_op_us_after": torch_op_us(torch)}
    print("host_step_ab " + json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
