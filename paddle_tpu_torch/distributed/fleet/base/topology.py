"""The hybrid-parallel topology (counterpart of
`paddle_tpu/distributed/fleet/base/topology.py`; reference:
python/paddle/distributed/fleet/base/topology.py:52 CommunicateTopology,
:134 HybridCommunicateGroup).

`HybridCommunicateGroup` installs the mesh of ranks over the canonical
axes dp, pp, sharding, (sp,) mp with `env.build_mesh`: one controller
drives every rank of a one-process mesh, and under a process group the
ranks split into one block a process (ROADMAP C.21 counts ranks, not
devices). Its groups are mesh-axis `Group`s. Ranks: with one process
every `get_*_rank` and `get_stage_id` is 0, as the reference's one
controller reads them; under a process group they are the coordinates of
this process's first rank. An axis group whose ranks span processes
reaches them through a `torch.distributed` group over those processes,
made once (`Group.process_group`).
"""
import math

from ... import env
from ...collective import Group

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "model"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = None
        self._world_size = int(math.prod(int(d) for d in dims))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size


# paddle's axis names -> the mesh's ("sep" is paddle's sequence parallelism)
_AXIS_MAP = {"data": "dp", "pipe": "pp", "sharding": "sharding", "model": "mp",
             "sep": "sp"}


class HybridCommunicateGroup:
    def __init__(self, topology):
        self._topo = topology
        dims = {_AXIS_MAP[n]: topology.get_dim(n)
                for n in topology.get_hybrid_group_names()}
        order = [a for a in env.HYBRID_AXES if a in dims]
        self.mesh = env.build_mesh({a: dims[a] for a in order})
        self._dp_degree = dims.get("dp", 1)
        self._mp_degree = dims.get("mp", 1)
        self._pp_degree = dims.get("pp", 1)
        self._sharding_degree = dims.get("sharding", 1)
        self._sep_degree = dims.get("sp", 1)

    def _coord(self, axis):
        """This process's first rank's coordinate on `axis` (0 for one
        process)."""
        mesh = self.mesh
        if axis not in mesh.dims:
            return 0
        return int(mesh.coords[mesh.local_ranks[0]][axis])

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_data_parallel_rank(self):
        return self._coord("dp")

    def get_model_parallel_rank(self):
        return self._coord("mp")

    def get_stage_id(self):
        return self._coord("pp")

    def get_sharding_parallel_rank(self):
        return self._coord("sharding")

    def get_sep_parallel_rank(self):
        return self._coord("sp")

    def get_global_rank(self):
        return env.get_rank()

    def get_data_parallel_group(self):
        return Group(axis_name="dp", mesh=self.mesh)

    def get_model_parallel_group(self):
        return Group(axis_name="mp", mesh=self.mesh)

    def get_pipe_parallel_group(self):
        return Group(axis_name="pp", mesh=self.mesh)

    def get_sharding_parallel_group(self):
        return Group(axis_name="sharding", mesh=self.mesh)

    def get_sep_parallel_group(self):
        return Group(axis_name="sp", mesh=self.mesh)

    def get_check_parallel_group(self, *a):
        return Group(axis_name=None, mesh=self.mesh)

    def get_data_parallel_group_src_rank(self):
        return 0

    def get_model_parallel_group_src_rank(self):
        return 0

    def topology(self):
        return self._topo

    def get_parallel_mode(self):
        if self._pp_degree > 1:
            return "pipeline"
        if self._sharding_degree > 1:
            return "sharding"
        if self._mp_degree > 1:
            return "model"
        return "data"
