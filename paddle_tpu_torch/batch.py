"""paddle.batch and the reader combinators for the port (counterpart of
`paddle_tpu/batch.py`): host-side iterator plumbing for fluid-style input
pipelines; the modern path is `io.DataLoader`."""
import random as _random

__all__ = ["batch"]


def batch(reader, batch_size, drop_last=False):
    """Wrap a sample reader into a batch reader."""
    def batch_reader():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    return batch_reader


def shuffle(reader, buf_size):
    """Buffered shuffle combinator (Python's `random`)."""
    def shuffled():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        _random.shuffle(buf)
        yield from buf
    return shuffled


def chain(*readers):
    def chained():
        for r in readers:
            yield from r()
    return chained


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, check_alignment=True):
    """Zip readers into tuples of their items. Misaligned readers raise
    ComposeNotAligned unless check_alignment=False."""
    def composed():
        iters = [r() for r in readers]
        sentinel = object()
        while True:
            items = [next(it, sentinel) for it in iters]
            done = [it is sentinel for it in items]
            if all(done):
                return
            if any(done):
                if check_alignment:
                    raise ComposeNotAligned(
                        "compose: input readers yielded different lengths")
                return
            out = []
            for it in items:
                out.extend(it if isinstance(it, tuple) else (it,))
            yield tuple(out)
    return composed


def map_readers(func, *readers):
    def mapped():
        for items in zip(*[r() for r in readers]):
            yield func(*items)
    return mapped


def firstn(reader, n):
    def limited():
        for i, item in enumerate(reader()):
            if i >= n:
                return
            yield item
    return limited
