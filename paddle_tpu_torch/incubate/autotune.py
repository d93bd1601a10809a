"""Kernel autotune (counterpart of `paddle_tpu/incubate/autotune.py`;
reference: python/paddle/incubate/autotune.py + phi/kernels/autotune/cache.h
— the runtime kernel-pick cache).

The knob the port owns is the tiling of its hand-written kernels. Each
kernel is built at a few tiles (`ops.flash_attention.BUILDS`,
`ops.paged_attention.SPLIT_KEYS` / `CHUNK_KEYS`), all compiled into its
library at first use, and every CUDA launch takes its tile at launch from
this table: the flash ops and the paged wrapper look their geometry up on
every call, a kernel runs the table's pair where it has a build at that
pair, and its own default otherwise (no entry, `kernel.enable` off, or a
pair no build has). `autotune_flash_blocks` times the flash builds for a
concrete shape on the card and caches the winner keyed by (backend, H, S,
D, causal) — in memory, in an optional env-path disk cache, and via the
shipped `ops/flash_blocks_tuned.json` table, the phi AlgorithmsCache role.

What an entry means here:
  * flash `(block_q, block_k)`: the query rows and key rows of a tile of
    all three flash kernels (the forward's block and key tile; dQ's query
    block and streamed key tile; dK/dV's streamed query tile and key
    block). The pair (128, 128) runs every 16-bit kernel's default (the
    forward's; dQ and dK/dV have no build there); (64, 64) is the
    CUDA-core kernels' one build;
  * paged `(split_keys, chunk_keys)`: the keys one thread block covers in
    the decode, window and tile kernels, and the keys the tile kernel
    stages a step.
A pair is valid where some build has it; a lookup of a pair no build has
returns None (the kernels then take their defaults), and never raises.
The backend field is "cuda" for CUDA tensors and "cpu" for CPU tensors
(whose plain versions take no tile): the wrappers pass the device, and
nothing here queries a device.

A CUDA graph fixes its tiles at capture: an entry committed later takes
effect at the next capture (as a retrace would in the reference).

The reference's dataloader/layout tuning knobs remain config-only.
"""
import json
import os
import time

__all__ = ["set_config", "get_config", "kernel_tuning_enabled",
           "lookup_flash_blocks", "lookup_paged_blocks",
           "record_flash_blocks", "commit_shipped_table",
           "autotune_flash_blocks"]

_config = {"kernel": {"enable": True, "tuning_range": [1, 10]},
           "dataloader": {"enable": False},
           "layout": {"enable": False}}

# Two kernels share the table. Flash keys are UNTAGGED (the original
# format): (backend, H, S, D, causal) -> (block_q, block_k). Paged-
# attention keys lead with a kernel tag: ("paged", backend, H,
# padded_len, D, block_size) -> (split_keys, chunk_keys). Batch size is
# NOT part of either key: tiling is set by the geometry, so a winner
# tuned at one B serves every batch size. The tag check runs BEFORE the
# legacy-6-tuple collapse, so old flash caches keep parsing.
# _block_cache holds entries tuned IN THIS PROCESS (these get persisted to
# the env-path file); _disk_cache holds entries loaded from the shipped file
# and the env-path file (read-only — never written back, so an update of
# flash_blocks_tuned.json is never shadowed by a stale frozen copy in the
# user cache).
_KERNEL_TAGS = ("paged",)
_block_cache = {}
_disk_cache = {}
_disk_loaded = False
# geometries whose in-memory entry is a static FALLBACK, not a measured
# winner: excluded from every disk write so they can never shadow shipped
# tuned entries in a future process
_fallback_keys = set()
_CACHE_ENV = "PADDLE_TPU_AUTOTUNE_CACHE"


def set_config(config=None):
    if config:
        for k, v in config.items():
            if isinstance(v, dict) and isinstance(_config.get(k), dict):
                _config[k].update(v)       # per-section merge (reference
            else:                          # set_config semantics)
                _config[k] = v


def get_config():
    return dict(_config)


def kernel_tuning_enabled():
    return bool(_config.get("kernel", {}).get("enable"))


def _cache_path():
    return os.environ.get(_CACHE_ENV, "")


# Tiles shipped with the port: winners measured on the card by
# `chip_smoke.py --tune-only` and committed here, so every process starts
# from measured tiles. The env-path cache (per-user/runtime) overrides.
_SHIPPED_PATH = os.path.join(os.path.dirname(__file__), os.pardir, "ops",
                             "flash_blocks_tuned.json")


def _read_cache_file(path):
    if path and os.path.exists(path):
        try:
            with open(path) as f:
                out = {}
                for k, v in json.load(f).items():
                    key = tuple(json.loads(k))
                    if not (key and key[0] in _KERNEL_TAGS):
                        # untagged == flash
                        if len(key) == 6:  # legacy (backend,B,H,S,D,causal)
                            key = key[:1] + key[2:]
                    out[key] = tuple(v)
                return out
        except (OSError, ValueError):
            return {}
    return {}


def _load_disk_cache():
    merged = _read_cache_file(_SHIPPED_PATH)
    merged.update(_read_cache_file(_cache_path()))
    return merged


def _save_disk_cache():
    path = _cache_path()
    if path:
        try:
            # load-then-merge the env-path file only (never clobber entries
            # written by other processes sharing it; never freeze shipped
            # entries into the user cache)
            merged = _read_cache_file(path)
            merged.update({k: v for k, v in _block_cache.items()
                           if k not in _fallback_keys})
            with open(path, "w") as f:
                json.dump({json.dumps(list(k)): list(v)
                           for k, v in merged.items()}, f)
        except OSError:
            pass


def _backend(device):
    """"cuda" or "cpu": the table's backend field for a device (a
    `torch.device`, or its type or name as a string)."""
    kind = getattr(device, "type", None) or str(device).split(":")[0]
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"autotune: no tile table for device {device!r}")
    return kind


def _pair(entry):
    """A stored entry as a pair of ints, or None where it is not one."""
    try:
        a, b = int(entry[0]), int(entry[1])
    except (TypeError, ValueError, IndexError):
        return None
    return (a, b)


_pairs = {}            # kernel -> the pairs its builds have


def _flash_pairs():
    """Every (block_q, block_k) some flash build has."""
    got = _pairs.get("flash")
    if got is None:
        from ..ops import flash_attention as fa
        got = _pairs["flash"] = fa.build_pairs()
    return got


def _paged_pairs():
    """Every (split_keys, chunk_keys) the paged kernels are built at."""
    got = _pairs.get("paged")
    if got is None:
        from ..ops import paged_attention as pa
        got = _pairs["paged"] = frozenset(
            (s, c) for s in pa.SPLIT_KEYS for c in pa.CHUNK_KEYS)
    return got


def _entry(key):
    """The table's entry for `key`: tuned in this process, else the disk's
    (read once a process, the shipped file under the env-path one)."""
    global _disk_loaded
    hit = _block_cache.get(key)
    if hit is not None:
        return hit
    if not _disk_loaded:
        _disk_cache.update(_load_disk_cache())
        _disk_loaded = True
    return _disk_cache.get(key)


def lookup_flash_blocks(B, H, S, D, causal, device="cuda"):
    """Cached (block_q, block_k) for this geometry on `device`'s backend,
    or None (B is accepted for call-site convenience but is not part of
    the key). Honors the kernel.enable knob. Disk caches (shipped file +
    env path) are read once per process; entries tuned by other processes
    after that point become visible on the next process start. In-process
    tuned entries win over disk entries. A stale or hand-poisoned entry —
    not a pair of ints, or a pair no build has — is treated as absent (the
    kernels then take their defaults), never raised: the ops consult this
    on every launch."""
    if not kernel_tuning_enabled():
        return None
    pair = _pair(_entry((_backend(device), int(H), int(S), int(D),
                         bool(causal))) or ())
    return pair if pair in _flash_pairs() else None


def lookup_paged_blocks(H, padded_len, D, block_size, device="cuda"):
    """Tuned (split_keys, chunk_keys) for the paged-attention kernels'
    geometry on `device`'s backend, or None. Same caches and enable knob
    as the flash lookup, and the same fall-back-don't-raise contract: an
    entry that is not a pair the kernels are built at is treated as
    absent, and the kernels tile with their own defaults. The key has no
    T: one pair serves the decode, the windows and the prefill tiles."""
    if not kernel_tuning_enabled():
        return None
    pair = _pair(_entry(("paged", _backend(device), int(H), int(padded_len),
                         int(D), int(block_size))) or ())
    return pair if pair in _paged_pairs() else None


def record_flash_blocks(H, S, D, causal, blocks, persist=True,
                        device="cuda"):
    """Record an externally-measured (block_q, block_k) winner for a
    geometry and persist it to the env-path cache if configured.
    persist=False keeps the entry in-memory only — used for static
    FALLBACK results, which must never shadow shipped tuned entries at
    the next load."""
    key = (_backend(device), H, S, D, bool(causal))
    _block_cache[key] = tuple(blocks)
    if persist:
        _fallback_keys.discard(key)
        _save_disk_cache()
    else:
        _fallback_keys.add(key)


def commit_shipped_table(entries, backend="cuda", path=None, kernel="flash"):
    """Commit measured winners into the SHIPPED table
    (`ops/flash_blocks_tuned.json`) — the path on-card sweep results
    (`chip_smoke.py --tune-only`) take into the tree, using the exact
    cache serialization the lookups read back.

    kernel="flash": entries {(H, S, D, causal): (block_q, block_k)}.
    kernel="paged": entries {(H, padded_len, D, block_size):
    (split_keys, chunk_keys)}. A pair no build has raises ValueError.
    Existing shipped entries for other geometries/kernels are preserved
    (load-then-merge). The in-process disk cache is invalidated so the
    committing process sees its own commit."""
    global _disk_loaded
    if kernel not in ("flash",) + _KERNEL_TAGS:
        raise ValueError(f"unknown kernel {kernel!r}; want 'flash' or one "
                         f"of {_KERNEL_TAGS}")
    path = path or _SHIPPED_PATH
    merged = _read_cache_file(path)
    for key, blocks in entries.items():
        pair = _pair(blocks)
        if kernel == "paged":
            H, L, D, bs = key
            if pair not in _paged_pairs():
                raise ValueError(f"paged tiles {blocks} are no build's: "
                                 f"want one of {sorted(_paged_pairs())}")
            if int(L) % int(bs):
                raise ValueError(f"padded_len {L} is not a multiple of "
                                 f"block_size {bs}")
            merged[("paged", backend, int(H), int(L), int(D), int(bs))] = \
                pair
            continue
        H, S, D, causal = key
        if pair not in _flash_pairs():
            raise ValueError(f"flash blocks {blocks} are no build's: want "
                             f"one of {sorted(_flash_pairs())}")
        merged[(backend, int(H), int(S), int(D), bool(causal))] = pair
    with open(path, "w") as f:
        json.dump({json.dumps(list(k)): list(v)
                   for k, v in sorted(merged.items())}, f, indent=1)
    _disk_cache.clear()
    _disk_loaded = False
    return path


def autotune_flash_blocks(B, H, S, D, causal=True, dtype="bfloat16",
                          candidates=None, n_iters=3, device="cuda"):
    """Measure each candidate (block_q, block_k) and cache the fastest.
    Returns (block_q, block_k). On "cuda" each candidate runs the forward,
    dQ and dK/dV (the pair steers all three) on random [B, H, S, D]
    inputs, timed with CUDA events after an L2 flush; on "cpu" each runs
    the plain versions, so the choice is valid but means nothing for speed.
    Candidates default to `ops.flash_attention.TUNE_PAIRS`; a pair no
    build has, or one that fails, is skipped; where none runs, the
    defaults' pair is recorded in memory only, never persisted."""
    import torch

    from ..ops import flash_attention as fa

    hit = lookup_flash_blocks(B, H, S, D, causal, device=device)
    if hit is not None:
        return hit
    if not kernel_tuning_enabled():
        return fa.DEFAULT_PAIR
    dev = torch.device(device)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    g = torch.Generator(device=dev).manual_seed(0)
    q = (torch.randn((B * H, S, D), generator=g, device=dev) * 0.1).to(dt)
    do = (torch.randn((B * H, S, D), generator=g, device=dev) * 0.1).to(dt)
    meta = fa.Meta(H=H, Hk=H, causal=bool(causal), scale=D ** -0.5)
    cuda = dev.type == "cuda"
    flush = torch.empty(64 * 1024 * 1024, device=dev) if cuda else None

    def run(pair):
        o, lse = fa.tiled_fwd(q, q, q, None, meta, pair)
        delta = (do.float() * o.float()).sum(-1)
        fa.tiled_dq(q, q, q, do, lse, delta, None, meta, pair)
        fa.tiled_dkv(q, q, q, do, lse, delta, None, meta, pair)

    def timed(pair):
        run(pair)                                    # build + warm
        total = 0.0
        for _ in range(n_iters):
            if cuda:
                flush.add_(1.0)
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                run(pair)
                e.record()
                torch.cuda.synchronize(dev)
                total += s.elapsed_time(e) / 1e3
            else:
                t0 = time.perf_counter()
                run(pair)
                total += time.perf_counter() - t0
        return total

    pairs = _flash_pairs()
    best, best_dt = None, float("inf")
    for pair in candidates or fa.TUNE_PAIRS:
        pair = _pair(pair)
        if pair not in pairs:
            continue
        try:
            dt_s = timed(pair)
        except (RuntimeError, ValueError):
            continue
        if dt_s < best_dt:
            best, best_dt = pair, dt_s
    fallback = best is None
    if fallback:
        best = fa.DEFAULT_PAIR
    # fallbacks stay in-memory only: a persisted fallback would override the
    # shipped tuned table for this geometry on every future load
    record_flash_blocks(H, S, D, causal, best, persist=not fallback,
                        device=device)
    return best
