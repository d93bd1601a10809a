"""Pretrained-weight paths (counterpart of `paddle_tpu/utils/download.py`).
There is no network: a file already in place is returned, and anything
else raises with the path where the file is expected."""
import os

__all__ = ["get_weights_path_from_url", "get_path_from_url"]

WEIGHTS_HOME = os.path.expanduser("~/.cache/paddle_tpu_torch/weights")


def _local(url, root):
    path = os.path.join(root, os.path.basename(url))
    if os.path.exists(path):
        return path
    raise RuntimeError(
        f"cannot download {url} (no network); place the file at {path} "
        f"and retry")


def get_weights_path_from_url(url, md5sum=None):
    path = _local(url, WEIGHTS_HOME)
    if not os.path.isfile(path):
        raise RuntimeError(f"{path} is not a file")
    return path


def get_path_from_url(url, root_dir=None, md5sum=None, check_exist=True):
    return _local(url, root_dir or WEIGHTS_HOME)
