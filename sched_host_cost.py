#!/usr/bin/env python3
"""Time the scheduler's host work a step, apart from the model.

    python3 sched_host_cost.py [--steps 900] [--reps 7]

Builds a small paged engine on the CPU (the host work of a step does not
depend on the model's width: the model runs only inside
`engine.decode()`), places eight requests, replaces `engine.decode()` by
a function returning a constant token array, and times
`Scheduler.step()` over `--steps` steps (the requests run that long), on
a fresh scheduler each of `--reps` times. Prints one JSON
line: the median µs a step over the repetitions, with the metrics
registry on, and, where the tree has the observability substrate, with
the registry off and with the serving JSONL (`metrics_path`, written
under `build/`). Run it from two checkouts on one machine to compare
their schedulers' host cost.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def _engine():
    from paddle_tpu_torch.serving import PagedGenerationEngine
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig
    model = GPT(GPTConfig(hidden_size=64, num_layers=1, num_heads=4,
                          max_position_embeddings=1024, vocab_size=1024),
                device="cpu", seed=0)
    return PagedGenerationEngine(model, device="cpu", slots=8, max_len=1024,
                                 block_size=16)


def one_rep(eng, steps, jsonl):
    """µs a step of eight running requests, decode replaced."""
    import numpy as np
    from paddle_tpu_torch.serving import Scheduler
    kw = {"max_queue": 64}
    if jsonl:
        kw["metrics_path"] = jsonl
    sched = Scheduler(eng, device="cpu", **kw)
    for i in range(8):
        sched.submit(list(range(1 + i, 17 + i)), max_new_tokens=steps + 2)
    sched.step()                      # placement and one real decode
    const = np.arange(8, dtype=np.int32)
    eng.decode = lambda: const.copy()
    try:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        dt = (time.perf_counter() - t0) / steps * 1e6
    finally:
        del eng.decode
    for s in range(eng.slots):
        eng.reset_slot(s)
    eng.prefix_cache.evict(eng.block_pool.capacity)
    close = getattr(sched, "close", None)
    if close is not None:
        close()
    return dt


def run(eng, steps, reps, registry_on=True, jsonl=None):
    """The median over `reps` of `one_rep`."""
    reg = None
    if not registry_on:
        from paddle_tpu_torch.observability import metrics
        reg = metrics.registry()
        reg.disable()
    try:
        out = sorted(one_rep(eng, steps, jsonl) for _ in range(reps))
    finally:
        if reg is not None:
            reg.enable()
    return out[len(out) // 2]


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=900)
    p.add_argument("--reps", type=int, default=7)
    args = p.parse_args(argv)
    if args.steps > 1000 - 20:
        p.error("--steps must leave the requests' tokens within max_len")
    sys.path.insert(0, ROOT)
    eng = _engine()
    res = {"tree": ROOT, "step_us": run(eng, args.steps, args.reps)}
    try:
        import paddle_tpu_torch.observability  # noqa: F401
    except ImportError:
        pass
    else:
        res["step_us_registry_off"] = run(eng, args.steps, args.reps,
                                          False)
        path = os.path.join(ROOT, "build", "sched_host_cost.jsonl")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        res["step_us_jsonl"] = run(eng, args.steps, args.reps, jsonl=path)
        os.remove(path)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
