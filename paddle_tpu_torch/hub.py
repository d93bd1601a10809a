"""paddle.hub of the port (counterpart of `paddle_tpu/hub.py`): list, help
and load over a local repo exposing hubconf.py. There is no network: only
source="local" works; remote sources raise with the local alternative.
"""
import importlib.util
import os
import sys

__all__ = ["list", "help", "load"]


def _load_hubconf(repo_dir):
    path = os.path.join(repo_dir, "hubconf.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no hubconf.py under {repo_dir!r}")
    spec = importlib.util.spec_from_file_location(
        "paddle_tpu_torch_hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["paddle_tpu_torch_hubconf"] = mod
    spec.loader.exec_module(mod)
    return mod


def _check_source(source):
    if source != "local":
        raise RuntimeError(
            f"hub source {source!r} needs network access (this build has "
            f"none); clone the repo yourself and use source='local' with "
            f"repo_dir=<path>")


def _resolve(repo_dir, source):
    """Promote to local ONLY for explicit local paths (absolute or ./-
    prefixed) — a remote-looking 'user/repo' string must never silently
    execute whatever sits at a cwd-relative path."""
    explicit_path = os.path.isabs(repo_dir) or repo_dir.startswith((".", "~"))
    if explicit_path and os.path.isdir(os.path.expanduser(repo_dir)):
        return "local"
    return source


def list(repo_dir, source="github", force_reload=False):  # noqa: A001
    """Entrypoints exposed by the repo's hubconf.py."""
    source = _resolve(repo_dir, source)
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    return [n for n in dir(mod)
            if callable(getattr(mod, n)) and not n.startswith("_")]


def help(repo_dir, model, source="github", force_reload=False):  # noqa: A001
    source = _resolve(repo_dir, source)
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    return getattr(mod, model).__doc__


def load(repo_dir, model, source="github", force_reload=False, **kwargs):
    source = _resolve(repo_dir, source)
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    return getattr(mod, model)(**kwargs)
