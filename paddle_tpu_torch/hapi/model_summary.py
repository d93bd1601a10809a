"""`summary` and `flops` for the port (counterpart of
`paddle_tpu/hapi/model_summary.py`): the same table and counts."""
import numpy as np
import torch

from ..core.device import place_device
from ..core.tensor import Tensor


def summary(net, input_size=None, dtypes=None, input=None):
    rows = []
    total_params = 0
    trainable_params = 0
    for name, p in net.named_parameters():
        n = int(np.prod(p.shape)) if p.shape else 1
        total_params += n
        if not p.stop_gradient:
            trainable_params += n
        rows.append((name, tuple(p.shape), n))
    width = max([len(r[0]) for r in rows], default=20) + 2
    print(f"{'Layer (param)':<{width}}{'Shape':<20}{'Param #':>12}")
    print("-" * (width + 32))
    for name, shape, n in rows:
        print(f"{name:<{width}}{str(shape):<20}{n:>12,}")
    print("-" * (width + 32))
    print(f"Total params: {total_params:,}")
    print(f"Trainable params: {trainable_params:,}")
    print(f"Non-trainable params: {total_params - trainable_params:,}")
    return {"total_params": total_params, "trainable_params": trainable_params}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Analytic FLOPs for the common layers (conv/linear/matmul dominate)."""
    from ..nn import Conv2D, Linear

    total = [0]

    def hook(layer, inputs, outputs):
        x = inputs[0]
        if isinstance(layer, Conv2D):
            out = outputs if isinstance(outputs, Tensor) else outputs[0]
            k = np.prod(layer._kernel_size)
            cin = layer._in_channels // layer._groups
            total[0] += 2 * int(np.prod(out.shape)) * int(k) * cin
        elif isinstance(layer, Linear):
            total[0] += 2 * int(np.prod(x.shape)) * layer.out_features

    handles = []
    for _, sub in net.named_sublayers(include_self=True):
        handles.append(sub.register_forward_post_hook(hook))
    params = net.parameters()
    dev = params[0]._data.device if params else place_device()
    dummy = Tensor(torch.zeros(tuple(input_size), dtype=torch.float32,
                               device=dev))
    was_training = net.training
    net.eval()
    with torch.no_grad():
        net(dummy)
    if was_training:
        net.train()
    for h in handles:
        h.remove()
    return total[0]
