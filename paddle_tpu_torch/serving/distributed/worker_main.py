"""Process entry for one serving worker of the port.

    python -m paddle_tpu_torch.serving.distributed.worker_main \
        --role decode --engine paged --model gpt_tiny --seed 2024 \
        --engine-config '{"slots": 2, "max_len": 64}' \
        --endpoint-file /tmp/dec0.ep [--ckpt DIR] [--version 1] \
        [--device cuda]

Counterpart of `paddle_tpu/serving/distributed/worker_main.py`, with the
same flags plus `--device` (default "cuda"; without CUDA the process
exits non-zero unless `--device cpu` is passed). Every worker of a
deployment builds the same weights (the same `--seed`, or `--ckpt`, a
committed checkpoint of the port's model), builds its engine, captures
every serving executable as a CUDA graph (`engine.precompile()`) BEFORE
it serves, binds an OS-assigned port, publishes `host:port` atomically
through `--endpoint-file`, and serves until a client sends OP_STOP.

At exit it prints one line to stderr, `worker_main exit: {json}`: the
device, engine kind, `attention_impl`, the capture counts, the
paged-attention kernel launches its engine made and, on the card, its
peak allocated and reserved memory.

Environment (read by the process, inherited from its parent):
  PTN_TRACE_EXPORT_DIR  record host spans and export a chrome trace at
                        shutdown (worker_name = <role><index>), the
                        per-process half of `merge_chrome_traces`
  PTN_FAULTS            arm fault sites at import (observability.faults)
"""
import argparse
import json
import os
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--role", choices=("decode", "prefill"),
                   default="decode")
    p.add_argument("--engine", default="paged",
                   help="serving engine kind: dense|paged|spec|tp|pp|"
                        "spec_pp")
    p.add_argument("--model", default="gpt_tiny",
                   choices=("gpt_tiny", "gpt_125m"),
                   help="model factory in paddle_tpu_torch.text.models")
    p.add_argument("--seed", type=int, default=2024,
                   help="init seed of the model: every worker of a "
                        "deployment must agree (or pass --ckpt)")
    p.add_argument("--engine-config", default="{}",
                   help="JSON ctor kwargs for the engine config")
    p.add_argument("--serving-config", default="{}",
                   help="JSON ctor kwargs for ServingConfig (decode role)")
    p.add_argument("--endpoint-file", required=True)
    p.add_argument("--ckpt", default=None,
                   help="committed checkpoint dir to load initial "
                        "weights from (overrides the seeded init)")
    p.add_argument("--version", type=int, default=0)
    p.add_argument("--index", type=int, default=0,
                   help="worker index (trace export naming only)")
    p.add_argument("--step-interval", type=float, default=0.0,
                   help="decode-step pacing in seconds (test/chaos knob)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model and engine")
    args = p.parse_args(argv)

    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.distributed.checkpoint import load_state_dict
    from paddle_tpu_torch.profiler import _tracer, export_chrome_tracing
    from paddle_tpu_torch.observability import tracecontext
    from paddle_tpu_torch.serving import ServingConfig, make_engine
    from paddle_tpu_torch.serving.distributed.worker import ServingWorker
    from paddle_tpu_torch.text import models as _models

    device = resolve_device(args.device)
    trace_dir = os.environ.get("PTN_TRACE_EXPORT_DIR")
    if trace_dir:
        tracecontext.ensure_trace()
        _tracer.enabled = True

    model = getattr(_models, args.model)(device=device, seed=args.seed)
    if args.ckpt:
        model.load_state_dict(load_state_dict(args.ckpt, device=device))
    engine = make_engine(model, args.engine, json.loads(args.engine_config),
                         device=device)
    if args.engine in ("tp", "pp", "spec_pp"):
        # the sharded engines hold their own copies on the stage devices
        # and their masters on the host: the model's device tensors (the
        # truncated draft's are the same ones) go back to the host
        from paddle_tpu_torch.serving.distributed.pp import \
            free_eager_device_copies
        free_eager_device_copies(model)
    # every capture happens here, before a handler thread or the step
    # loop exists: a capture under traffic would be invalidated by their
    # CUDA work
    precompile = getattr(engine, "precompile", None)
    if precompile is not None:
        precompile()
    serving_cfg = ServingConfig(**json.loads(args.serving_config)) \
        if args.role == "decode" else None
    worker = ServingWorker(model, engine, role=args.role,
                           serving_config=serving_cfg,
                           version=args.version,
                           step_interval_s=args.step_interval)

    tmp = args.endpoint_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(worker.endpoint)
    os.replace(tmp, args.endpoint_file)      # atomic publish

    worker.serve_until_stopped()
    if trace_dir:
        time.sleep(0.2)                      # let handler spans close
        _tracer.enabled = False
        export_chrome_tracing(trace_dir, worker_name=f"{args.role}"
                              f"{args.index}")(_tracer.drain())
    launches = (worker.scheduler.metrics()["kernel_launches"]
                if worker.scheduler is not None
                else engine.kernel_launches)
    info = {"role": args.role, "device": str(device), "engine": args.engine,
            "attention_impl": getattr(engine.config, "attention_impl", None),
            "capture_counts": dict(engine.capture_counts),
            "kernel_launches": int(launches), "version": worker.version}
    if device.type == "cuda":
        import torch
        info["max_memory_allocated_mib"] = \
            torch.cuda.max_memory_allocated(device) / 2 ** 20
        info["memory_reserved_mib"] = \
            torch.cuda.memory_reserved(device) / 2 ** 20
    print("worker_main exit: " + json.dumps(info), file=sys.stderr,
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
