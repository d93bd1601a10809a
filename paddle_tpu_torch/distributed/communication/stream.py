"""paddle.distributed.communication.stream (counterpart of
`paddle_tpu/distributed/communication/stream.py`): the explicit-stream
collective variants. They delegate to the collective surface with
sync_op / use_calc_stream accepted for parity; each returns the
completed-task handle the reference's async form returns.
"""
from .. import collective as _c
from ..comm_extras import _Task

__all__ = ["all_gather", "all_reduce", "alltoall", "alltoall_single",
           "broadcast", "reduce", "reduce_scatter", "recv", "scatter",
           "send"]


def all_reduce(tensor, op=None, group=None, sync_op=True,
               use_calc_stream=False):
    _c.all_reduce(tensor, op or _c.ReduceOp.SUM, group)
    return _Task(tensor)


def all_gather(tensor_list, tensor, group=None, sync_op=True,
               use_calc_stream=False):
    _c.all_gather(tensor_list, tensor, group)
    return _Task(tensor)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True,
             use_calc_stream=False):
    _c.alltoall(in_tensor_list, out_tensor_list, group)
    return _Task(out_tensor_list[0] if out_tensor_list else None)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True,
                    use_calc_stream=False):
    _c.alltoall_single(in_tensor, out_tensor, in_split_sizes,
                       out_split_sizes, group)
    return _Task(out_tensor)


def broadcast(tensor, src=0, group=None, sync_op=True,
              use_calc_stream=False):
    _c.broadcast(tensor, src, group)
    return _Task(tensor)


def reduce(tensor, dst=0, op=None, group=None, sync_op=True,
           use_calc_stream=False):
    _c.reduce(tensor, dst, op or _c.ReduceOp.SUM, group)
    return _Task(tensor)


def reduce_scatter(tensor, tensor_list, op=None, group=None, sync_op=True,
                   use_calc_stream=False):
    _c.reduce_scatter(tensor, tensor_list, op or _c.ReduceOp.SUM, group)
    return _Task(tensor)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True,
            use_calc_stream=False):
    _c.scatter(tensor, tensor_list, src, group)
    return _Task(tensor)


def send(tensor, dst=0, group=None, sync_op=True, use_calc_stream=False):
    _c.send(tensor, dst, group)
    return _Task(tensor)


def recv(tensor, src=0, group=None, sync_op=True, use_calc_stream=False):
    _c.recv(tensor, src, group)
    return _Task(tensor)
