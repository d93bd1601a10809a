"""paddle.distributed.launch: the multi-process job launcher (counterpart
of `paddle_tpu/distributed/launch/`).

One process a rank: `python -m paddle_tpu_torch.distributed.launch
--nproc_per_node 2 train.py` starts two trainers with the PADDLE_*
variables that `distributed.init_parallel_env()` reads, and the
watchdog loop tears the job down when a trainer dies. `--elastic_level
1` relaunches a failed job (`fleet/elastic`).
"""
from .main import launch, main  # noqa: F401
