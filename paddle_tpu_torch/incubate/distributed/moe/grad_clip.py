"""The MoE-aware global-norm gradient clip (counterpart of
`paddle_tpu/incubate/distributed/moe/grad_clip.py`; reference:
python/paddle/incubate/distributed/models/moe/grad_clip.py
ClipGradForMOEByGlobalNorm): the global norm counts every expert's
gradient once. Expert parameters live only on their ep rank, so their
squared norms are all-reduced over the moe group (when it has more than
one rank) and added to the replicated parameters' norm before the clip
ratio is computed."""
import torch

from ....core.tensor import _wrap
from ....nn.clip import ClipGradBase

__all__ = ["ClipGradForMOEByGlobalNorm"]


class ClipGradForMOEByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, is_expert_param_func=None, moe_group=None,
                 group_name="default_moe_group"):
        self.clip_norm = float(clip_norm)
        self.moe_group = moe_group
        if moe_group is not None and getattr(moe_group, "nranks", 1) > 1 \
                and is_expert_param_func is None:
            raise AssertionError(
                "is_expert_param_func is required when moe_group spans "
                "multiple ranks")
        self.is_expert_param_func = is_expert_param_func
        self.group_name = group_name

    def _is_expert(self, p):
        if self.is_expert_param_func is not None:
            return bool(self.is_expert_param_func(p))
        return bool(getattr(p, "is_expert", False))

    @staticmethod
    def _skip(p, g):
        return g is None or (hasattr(p, "need_clip") and not p.need_clip)

    def __call__(self, params_grads):
        normal_sq, expert_sq = [], []
        for p, g in params_grads:
            if self._skip(p, g):
                continue
            sq = (g._data.float() ** 2).sum()
            (expert_sq if self._is_expert(p) else normal_sq).append(sq)
        if not normal_sq and not expert_sq:
            return params_grads
        norm_sq = sum(normal_sq) if normal_sq else torch.zeros(())
        if expert_sq:
            e = sum(expert_sq)
            if self.moe_group is not None and \
                    getattr(self.moe_group, "nranks", 1) > 1:
                from ....distributed import collective
                t = _wrap(e)
                collective.all_reduce(t, group=self.moe_group)
                e = t._data
            norm_sq = norm_sq + e
        global_norm = torch.sqrt(norm_sq)
        scale = self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)
        return [(p, g) if self._skip(p, g) else
                (p, _wrap((g._data * scale).to(g._data.dtype)))
                for p, g in params_grads]
