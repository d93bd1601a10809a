"""Launcher entry: spawn trainers, set PADDLE_* env, watch for failures
(counterpart of `paddle_tpu/distributed/launch/main.py`).

`python -m paddle_tpu_torch.distributed.launch` builds each rank's
environment (PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM,
PADDLE_TRAINER_ENDPOINTS, PADDLE_CURRENT_ENDPOINT, PADDLE_MASTER,
FLAGS_selected_devices), starts one process a rank and tears the job down
when any of them fails (`watch_local_trainers`).

Two differences from the reference, both for the process group of
`env.init_parallel_env`:
  * with `--nproc_per_node` > 1 and no `--master`, PADDLE_MASTER is a free
    local port, so the ranks can rendezvous;
  * `--devices` (a comma list of card ids) selects the card each rank
    uses: rank i takes the (i mod n)-th; on a one-card host every rank
    is on card 0. Without it every rank takes the current place's card.
"""
import argparse
import os
import signal
import socket
import subprocess
import sys
import time


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def build_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--nnodes", type=str, default="1",
                   help="N or N:M (elastic range)")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="trainers per node (one process a rank)")
    p.add_argument("--master", type=str, default=None,
                   help="rendezvous host:port (rank-0 hosts the TCPStore)")
    p.add_argument("--rank", type=int, default=0, help="node rank")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--run_mode", type=str, default="collective",
                   choices=["collective", "ps"])
    p.add_argument("--devices", type=str, default=None)
    p.add_argument("--elastic_level", type=int, default=-1)
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _trainer_env(args, local_rank, n_local, port_base, master=None):
    nnodes = int(str(args.nnodes).split(":")[0])
    world = nnodes * n_local
    rank = args.rank * n_local + local_rank
    host = "127.0.0.1"
    endpoints = ",".join(f"{host}:{port_base + i}" for i in range(world))
    env = dict(os.environ)
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_CURRENT_ENDPOINT": f"{host}:{port_base + rank}",
        "PADDLE_TRAINER_ENDPOINTS": endpoints,
        "PADDLE_RANK_IN_NODE": str(local_rank),
        "PADDLE_LOCAL_SIZE": str(n_local),
    })
    master = args.master or master
    if master:
        env["PADDLE_MASTER"] = master
    if args.devices is not None:
        cards = [c for c in str(args.devices).split(",") if c != ""]
        env["FLAGS_selected_devices"] = cards[local_rank % len(cards)]
    return env


def watch_local_trainers(procs, timeout_s=None):
    """Block until all trainers exit; on ANY failure kill the rest and
    return its exit code (reference: launch_utils.watch_local_trainers)."""
    deadline = time.monotonic() + timeout_s if timeout_s else None
    alive = list(procs)
    while alive:
        for p in list(alive):
            rc = p.poll()
            if rc is None:
                continue
            alive.remove(p)
            if rc != 0:
                for q in alive:
                    try:
                        q.send_signal(signal.SIGTERM)
                    except OSError:
                        pass
                t0 = time.monotonic()
                while any(q.poll() is None for q in alive) and \
                        time.monotonic() - t0 < 10:
                    time.sleep(0.2)
                for q in alive:
                    if q.poll() is None:
                        q.kill()
                return rc
        if deadline and time.monotonic() > deadline:
            for q in alive:
                q.kill()
            return 124
        time.sleep(0.5)
    return 0


def launch(argv=None):
    args = build_args(argv)
    n_local = args.nproc_per_node
    port_base = _free_port()
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)

    if args.elastic_level > 0:
        from ..fleet.elastic import enable_elastic, launch_elastic
        if enable_elastic(args):
            return launch_elastic(args, _spawn_once)

    return _spawn_once(args, n_local, port_base)


def _spawn_once(args, n_local, port_base):
    procs = []
    master = None
    if n_local > 1 and not args.master:
        master = f"127.0.0.1:{_free_port()}"
    for local_rank in range(n_local):
        env = _trainer_env(args, local_rank, n_local, port_base, master)
        cmd = [sys.executable, args.training_script] + \
            args.training_script_args
        if args.log_dir:
            log = open(os.path.join(
                args.log_dir, f"workerlog.{local_rank}"), "w")
            procs.append(subprocess.Popen(cmd, env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
        else:
            procs.append(subprocess.Popen(cmd, env=env))
    rc = watch_local_trainers(procs)
    if rc != 0:
        print(f"[launch] trainer failed with exit code {rc}",
              file=sys.stderr)
    return rc


def main():
    sys.exit(launch())


if __name__ == "__main__":
    main()
