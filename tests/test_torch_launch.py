"""The port's launcher and elastic manager: the counterparts of every test
in `tests/test_launch.py`, run through `paddle_tpu_torch.distributed`.

Trainer scripts import nothing heavy (os, sys, time). Beside the
reference's behaviours: a job of more than one rank gets a free local
PADDLE_MASTER when `--master` is absent (the process group rendezvouses
there), `--devices` gives each rank its own card id, and the command line
`python -m paddle_tpu_torch.distributed.launch` runs a job.
"""
import os
import subprocess
import sys
import time

from paddle_tpu_torch import native
from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
from paddle_tpu_torch.distributed.launch.main import (build_args, launch,
                                                      watch_local_trainers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_launch(script_body, tmp_path, extra=()):
    script = tmp_path / "trainer.py"
    script.write_text(script_body)
    argv = list(extra) + [str(script)]
    return launch(argv)


def _env_dump(out, keys):
    return ("import os\n"
            f"open({str(out)!r}, 'a').write(' '.join("
            f"os.environ.get(k, '-') for k in {list(keys)!r}) + '\\n')\n")


def test_launch_sets_trainer_env(tmp_path):
    out = tmp_path / "env.txt"
    body = (
        "import os\n"
        f"open({str(out)!r}, 'a').write("
        "os.environ['PADDLE_TRAINER_ID'] + '/' + "
        "os.environ['PADDLE_TRAINERS_NUM'] + '\\n')\n"
    )
    rc = _run_launch(body, tmp_path, ["--nproc_per_node", "2"])
    assert rc == 0
    lines = sorted(out.read_text().splitlines())
    assert lines == ["0/2", "1/2"]


def test_launch_sets_master_and_devices(tmp_path):
    out = tmp_path / "env.txt"
    keys = ("PADDLE_TRAINER_ID", "PADDLE_MASTER", "FLAGS_selected_devices",
            "PADDLE_CURRENT_ENDPOINT")
    rc = _run_launch(_env_dump(out, keys), tmp_path,
                     ["--nproc_per_node", "2", "--devices", "0"])
    assert rc == 0
    rows = sorted(line.split() for line in out.read_text().splitlines())
    assert [r[0] for r in rows] == ["0", "1"]
    master = {r[1] for r in rows}
    assert len(master) == 1 and master.pop().startswith("127.0.0.1:")
    assert [r[2] for r in rows] == ["0", "0"]   # one card: both on card 0
    assert rows[0][3] != rows[1][3]
    out.unlink()
    rc = _run_launch(_env_dump(out, keys), tmp_path,
                     ["--nproc_per_node", "2", "--devices", "0,1",
                      "--master", "10.0.0.1:7000"])
    assert rc == 0
    rows = sorted(line.split() for line in out.read_text().splitlines())
    assert [(r[1], r[2]) for r in rows] == [("10.0.0.1:7000", "0"),
                                            ("10.0.0.1:7000", "1")]
    out.unlink()
    rc = _run_launch(_env_dump(out, keys), tmp_path, [])
    assert rc == 0
    assert out.read_text().split() == ["0", "-", "-",
                                       out.read_text().split()[3]]


def test_launch_watchdog_kills_survivors(tmp_path):
    marker = tmp_path / "lived_too_long"
    body = (
        "import os, sys, time\n"
        "rank = int(os.environ['PADDLE_TRAINER_ID'])\n"
        "if rank == 0:\n"
        "    sys.exit(3)\n"
        "time.sleep(30)\n"
        f"open({str(marker)!r}, 'w').write('x')\n"
    )
    t0 = time.monotonic()
    rc = _run_launch(body, tmp_path, ["--nproc_per_node", "2"])
    assert rc == 3
    assert time.monotonic() - t0 < 25, "watchdog did not kill the survivor"
    assert not marker.exists()


def test_watch_local_trainers_all_ok():
    procs = [subprocess.Popen([sys.executable, "-c", "pass"])
             for _ in range(2)]
    assert watch_local_trainers(procs) == 0


def test_watch_local_trainers_timeout():
    procs = [subprocess.Popen([sys.executable, "-c",
                               "import time; time.sleep(30)"])]
    t0 = time.monotonic()
    assert watch_local_trainers(procs, timeout_s=0.5) == 124
    assert time.monotonic() - t0 < 10
    procs[0].wait(timeout=10)


def test_build_args_remainder():
    args = build_args(["--nproc_per_node", "4", "train.py", "--lr", "0.1"])
    assert args.nproc_per_node == 4
    assert args.training_script == "train.py"
    assert args.training_script_args == ["--lr", "0.1"]


def test_launch_module_command_line(tmp_path):
    out = tmp_path / "env.txt"
    script = tmp_path / "trainer.py"
    script.write_text(_env_dump(out, ("PADDLE_TRAINER_ID",
                                      "PADDLE_TRAINERS_NUM")))
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--log_dir", str(tmp_path / "logs"),
         str(script)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert sorted(out.read_text().splitlines()) == ["0 2", "1 2"]
    assert sorted(os.listdir(tmp_path / "logs")) == ["workerlog.0",
                                                     "workerlog.1"]


def test_elastic_manager_leases():
    from paddle_tpu_torch.distributed import TCPStore

    assert native.available("kvstore"), native.build_error("kvstore")
    store = TCPStore(is_master=True, world_size=2, timeout=5.0)
    m0 = ElasticManager(store, rank=0, np_range=(1, 2), ttl_s=1.0,
                        heartbeat_s=0.2)
    m1 = ElasticManager(store, rank=1, np_range=(1, 2), ttl_s=1.0,
                        heartbeat_s=0.2)
    m0.register()
    m1.register()
    time.sleep(0.4)
    assert sorted(m0.alive_nodes(2)) == [0, 1]
    assert not m0.need_rescale(2)
    # rank 1 dies: its lease lapses, rescale becomes necessary
    m1.exit()
    time.sleep(1.3)
    assert m0.alive_nodes(2) == [0]
    assert m0.need_rescale(2)
    m0.exit()
    store.stop()


def test_elastic_relaunch_after_crash(tmp_path):
    """A trainer that crashes once is relaunched by the elastic
    supervisor and the job completes."""
    sentinel = tmp_path / "crashed_once"
    script = tmp_path / "flaky_trainer.py"
    script.write_text(
        "import os, sys\n"
        f"s = {str(sentinel)!r}\n"
        "if not os.path.exists(s):\n"
        "    open(s, 'w').write('x')\n"
        "    sys.exit(1)\n"              # first run: crash
        "open(s + '.done', 'w').write('ok')\n"
        "sys.exit(0)\n")
    rc = launch(["--elastic_level", "1", "--nnodes", "1", str(script)])
    assert rc == 0
    assert (tmp_path / "crashed_once.done").exists()


def test_elastic_gives_up_after_max_restarts(tmp_path, monkeypatch):
    """Persistent failure exhausts retries and propagates the exit code."""
    monkeypatch.setenv("PADDLE_ELASTIC_MAX_RESTARTS", "2")
    monkeypatch.setenv("PADDLE_ELASTIC_BACKOFF_S", "0.2")
    script = tmp_path / "always_fails.py"
    script.write_text("import sys; sys.exit(3)\n")
    rc = launch(["--elastic_level", "1", "--nnodes", "1", str(script)])
    assert rc == 3
