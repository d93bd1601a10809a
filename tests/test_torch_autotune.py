"""The port's kernel tile table (`paddle_tpu_torch/incubate/autotune.py`)
against the reference's (`paddle_tpu/incubate/autotune.py`), on the CPU.

Both packages write and read the same file format (JSON-list keys, flash
keys untagged, paged keys tagged "paged", the legacy 6-tuple collapsed),
obey the same cache rules (entries tuned in this process over disk
entries, the env-path file over the shipped one, the shipped file never
written back, fallbacks never persisted, the disk read once a process)
and agree on every lookup where their kernels agree on validity. Where
they depart (ROADMAP C.25): a port entry is the tile of the port's own
builds, and a pair no build has reads as absent. The launches are mocked
here (no card): a table pair must reach the kernels' C entry points, and
a pair no build has must reach the defaults. `attend_split_plain` at each
split the paged kernels are built at is held to the Pallas kernel in
interpret mode at 1e-5.
"""
import contextlib
import json
import os

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.incubate import autotune as jat
from paddle_tpu_torch.incubate import autotune as tat
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa

import test_torch_paged_attention as tpa


def _reset(mod, monkeypatch, shipped):
    """A fresh process's caches, with `shipped` as the shipped table."""
    monkeypatch.setattr(mod, "_SHIPPED_PATH", shipped)
    monkeypatch.setattr(mod, "_disk_loaded", False)
    monkeypatch.setattr(mod, "_disk_cache", {})
    monkeypatch.setattr(mod, "_block_cache", {})
    monkeypatch.setattr(mod, "_fallback_keys", set())


@pytest.fixture
def fresh(tmp_path, monkeypatch):
    """Both packages on one empty shipped table, no env cache, tuning on;
    returns the shipped path."""
    shipped = str(tmp_path / "shipped.json")
    monkeypatch.delenv("PADDLE_TPU_AUTOTUNE_CACHE", raising=False)
    for mod in (jat, tat):
        _reset(mod, monkeypatch, shipped)
        monkeypatch.setattr(mod, "_config", json.loads(json.dumps(
            mod._config)))
    return shipped


# entries both packages take: TPU-valid (multiples of 8 dividing S,
# square under causal) and a build of the port's
FLASH = {(4, 256, 64, True): (128, 128), (4, 256, 64, False): (128, 64),
         (2, 128, 64, True): (64, 64)}
PAGED = {(4, 64, 32, 4): (128, 64), (12, 1024, 64, 16): (256, 32)}
BACKEND = jax.default_backend()           # "cpu" under JAX_PLATFORMS=cpu


@pytest.mark.parametrize("kernel,entries", [("flash", FLASH),
                                            ("paged", PAGED)])
def test_commit_writes_the_reference_bytes(tmp_path, fresh, kernel,
                                           entries):
    pj, pt = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jat.commit_shipped_table(entries, backend=BACKEND, path=pj,
                             kernel=kernel)
    tat.commit_shipped_table(entries, backend=BACKEND, path=pt,
                             kernel=kernel)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    # merged into an existing file: the other kernel's entries are kept
    other = PAGED if kernel == "flash" else FLASH
    other_kernel = "paged" if kernel == "flash" else "flash"
    for mod, p in ((jat, pj), (tat, pt)):
        mod.commit_shipped_table(other, backend=BACKEND, path=p,
                                 kernel=other_kernel)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    # each package reads the other's file to the same dict
    assert jat._read_cache_file(pt) == tat._read_cache_file(pj) == \
        tat._read_cache_file(pt)


def test_read_cache_file_collapses_legacy_keys(tmp_path):
    p = tmp_path / "legacy.json"
    p.write_text(json.dumps({
        json.dumps(["cpu", 8, 4, 256, 64, True]): [128, 128],  # (B, ...)
        json.dumps(["cpu", 4, 128, 64, False]): [128, 64],
        json.dumps(["paged", "cpu", 4, 64, 32, 4]): [128, 64],
        json.dumps(["paged", "cuda", 12, 1024, 64, 16]): [256, 32]}))
    got = tat._read_cache_file(str(p))
    assert got == jat._read_cache_file(str(p))
    assert got[("cpu", 4, 256, 64, True)] == (128, 128)
    assert ("paged", "cuda", 12, 1024, 64, 16) in got
    (tmp_path / "rotten.json").write_text("{not json")
    assert tat._read_cache_file(str(tmp_path / "rotten.json")) == {} == \
        jat._read_cache_file(str(tmp_path / "rotten.json"))


def _both_paged(*geom):
    return (jat.lookup_paged_blocks(*geom),
            tat.lookup_paged_blocks(*geom, device="cpu"))


def _both_flash(*geom):
    return (jat.lookup_flash_blocks(*geom),
            tat.lookup_flash_blocks(*geom, device="cpu"))


def test_lookups_agree(tmp_path, fresh, monkeypatch):
    for mod in (jat, tat):
        mod.commit_shipped_table(FLASH, backend=BACKEND, path=fresh)
        mod.commit_shipped_table(PAGED, backend=BACKEND, path=fresh,
                                 kernel="paged")
    # valid entries, an absent geometry, another geometry of a present one
    for geom, want in (((4, 64, 32, 4), (128, 64)),
                       ((12, 1024, 64, 16), (256, 32)),
                       ((4, 128, 32, 4), None), ((4, 64, 32, 8), None)):
        assert _both_paged(*geom) == (want, want)
    for (H, S, D, causal), want in FLASH.items():
        assert _both_flash(1, H, S, D, causal) == (want, want)
        assert _both_flash(3, H, S, D, causal) == (want, want)  # B free
    assert _both_flash(1, 4, 512, 64, True) == (None, None)
    # another backend's entry is another key
    assert tat.lookup_paged_blocks(4, 64, 32, 4, device="cuda") is None
    # in-process entries over disk entries
    for mod in (jat, tat):
        mod.record_flash_blocks(4, 256, 64, True, (64, 64), persist=False,
                                **({} if mod is jat else {"device": "cpu"}))
    assert _both_flash(1, 4, 256, 64, True) == ((64, 64), (64, 64))
    # kernel.enable off: no entry at all
    for mod in (jat, tat):
        mod.set_config({"kernel": {"enable": False}})
        assert mod.get_config()["kernel"]["tuning_range"] == [1, 10]
    assert _both_paged(4, 64, 32, 4) == (None, None)
    assert _both_flash(1, 4, 256, 64, False) == (None, None)
    for mod in (jat, tat):
        mod.set_config({"kernel": {"enable": True}})
    # rotted entries read as absent and never raise
    raw = json.load(open(fresh))
    for k in list(raw):
        if json.loads(k)[0] == "paged":
            raw[k] = [0, -3]
    raw[json.dumps([BACKEND, 4, 256, 64, False])] = [96, 96]
    json.dump(raw, open(fresh, "w"))
    for mod in (jat, tat):
        _reset(mod, monkeypatch, fresh)
    assert _both_paged(4, 64, 32, 4) == (None, None)
    # the reference's flash lookup returns the raw pair (its entry point
    # falls back where the blocks do not tile S); the port's is no build's
    j, t = _both_flash(1, 4, 256, 64, False)
    assert j == (96, 96) and t is None
    # the env-path file over the shipped one
    env = str(tmp_path / "env.json")
    with open(env, "w") as f:
        json.dump({json.dumps(["paged", BACKEND, 4, 64, 32, 4]): [256, 64],
                   json.dumps([BACKEND, 4, 256, 64, True]): [128, 64]}, f)
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE", env)
    for mod in (jat, tat):
        _reset(mod, monkeypatch, fresh)
    assert _both_paged(4, 64, 32, 4) == ((256, 64), (256, 64))
    assert _both_flash(1, 4, 256, 64, True) == ((128, 64), (128, 64))
    # the disk is read once a process: a later file is not seen
    with open(env, "w") as f:
        json.dump({}, f)
    assert _both_paged(4, 64, 32, 4) == ((256, 64), (256, 64))


def test_commit_rejects_pairs_no_build_has(tmp_path, fresh):
    p = str(tmp_path / "t.json")
    with pytest.raises(ValueError, match="no build"):
        tat.commit_shipped_table({(4, 64, 32, 4): (0, -3)}, kernel="paged",
                                 path=p)
    with pytest.raises(ValueError, match="no build"):
        tat.commit_shipped_table({(4, 64, 32, 4): (128, 16)},
                                 kernel="paged", path=p)
    with pytest.raises(ValueError, match="multiple"):
        tat.commit_shipped_table({(4, 63, 32, 4): (128, 64)},
                                 kernel="paged", path=p)
    with pytest.raises(ValueError, match="no build"):
        tat.commit_shipped_table({(4, 256, 64, True): (96, 96)}, path=p)
    with pytest.raises(ValueError, match="unknown kernel"):
        tat.commit_shipped_table({}, kernel="conv", path=p)
    assert not os.path.exists(p)
    # the port's builds take ragged S and non-square causal tiles, which
    # the reference's TPU rules refuse
    tat.commit_shipped_table({(4, 200, 64, True): (128, 64)}, path=p)
    with pytest.raises(ValueError):
        jat.commit_shipped_table({(4, 200, 64, True): (128, 64)},
                                 backend=BACKEND, path=p)


def test_fallback_not_persisted(tmp_path, fresh, monkeypatch):
    """The counterpart of tests/test_advice_r5.py's: a fallback stays in
    memory, a measured winner persists, the fallback's geometry never."""
    cache = str(tmp_path / "blocks.json")
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE", cache)
    tat.record_flash_blocks(8, 1024, 64, True, (128, 128), persist=False)
    assert not os.path.exists(cache)
    assert tat.lookup_flash_blocks(2, 8, 1024, 64, True) == (128, 128)
    tat.record_flash_blocks(8, 2048, 64, True, (128, 64), persist=True)
    keys = [tuple(json.loads(k)) for k in json.load(open(cache))]
    assert keys == [("cuda", 8, 2048, 64, True)]
    # a fallback recorded after a winner is still never written
    tat.record_flash_blocks(8, 4096, 64, True, (128, 128), persist=False)
    tat.record_flash_blocks(8, 512, 64, True, (128, 64), persist=True)
    keys = {tuple(json.loads(k))[2] for k in json.load(open(cache))}
    assert keys == {2048, 512}
    # the shipped file is never written back into the user cache
    tat.commit_shipped_table({(8, 256, 64, True): (128, 128)}, path=fresh)
    tat.record_flash_blocks(8, 128, 64, True, (128, 64))
    keys = {tuple(json.loads(k))[2] for k in json.load(open(cache))}
    assert keys == {2048, 512, 128}


def test_cpu_tuner_keeps_the_cache_contract(tmp_path, fresh, monkeypatch):
    """The counterpart of tests/test_autotune.py's: a valid candidate,
    cached in memory and on disk, read back by a fresh load."""
    cache = tmp_path / "cache.json"
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE", str(cache))
    got = tat.autotune_flash_blocks(1, 2, 128, 64, causal=True,
                                    dtype="float32", n_iters=1,
                                    device="cpu")
    assert got in fa.TUNE_PAIRS and got in fa.build_pairs()
    assert tat.lookup_flash_blocks(1, 2, 128, 64, True, device="cpu") == got
    assert cache.exists()
    _reset(tat, monkeypatch, fresh)
    assert tat.lookup_flash_blocks(1, 2, 128, 64, True, device="cpu") == got
    # a hit is returned without tuning again
    assert tat.autotune_flash_blocks(1, 2, 128, 64, device="cpu") == got
    # no candidate runs: the defaults' pair, in memory only
    before = cache.read_bytes()
    assert tat.autotune_flash_blocks(1, 2, 256, 64, dtype="float32",
                                     candidates=((96, 96),), n_iters=1,
                                     device="cpu") == fa.DEFAULT_PAIR
    assert cache.read_bytes() == before
    assert tat.lookup_flash_blocks(1, 2, 256, 64, True, device="cpu") == \
        fa.DEFAULT_PAIR


# ------------------------------------------------------- the launches, mocked
class _FakeLib:
    """Stands in for a kernel library: records each entry point's
    arguments and returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, args))
            if name == "paged_attention_partial_floats":
                return 16
            if name == "paged_attention_ticket_count":
                return 4
            return 0
        return call


@contextlib.contextmanager
def _mocked_launch(monkeypatch, mod):
    """The CUDA launch of `mod` over CPU tensors: its library recorded,
    the stream calls stubbed."""
    lib = _FakeLib()

    class _Stream:
        cuda_stream = 0

    def kernel_lib(*name):
        lib.calls.append(("library", name))
        return lib
    monkeypatch.setattr(mod, "_kernel_lib", kernel_lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    yield lib


def _flash_tiles(lib):
    """(kernel, block_q, block_k) of each recorded flash launch."""
    return [(name.rsplit("_", 1)[1], args[-3], args[-2])
            for name, args in lib.calls if name != "library"]


def test_table_pair_reaches_the_flash_launches(fresh, monkeypatch):
    """The counterpart of tests/test_autotune.py's: a valid pair reaches
    each kernel that has a build at it, the others take their defaults,
    and a pair no build has (or tuning off) reaches the defaults."""
    B, H, S, D = 1, 2, 256, 64
    q = torch.zeros((B * H, S, D), dtype=torch.bfloat16)
    lse = torch.zeros((B * H, S))
    meta = fa.Meta(H=H, Hk=H, causal=True, scale=0.125)
    key = ("cuda", H, S, D, True)

    def launch_all():
        with _mocked_launch(monkeypatch, fa) as lib:
            fa._run("fwd", [q, q, q, None, q, lse], q, meta, None)
            fa._run("dq", [q, q, q, q, lse, lse, None, q], q, meta, None)
            fa._run("dkv", [q, q, q, q, lse, lse, None, q, q], q, meta,
                    None)
        return _flash_tiles(lib)
    defaults = [("fwd", 128, 128), ("dq", 128, 64), ("dkv", 64, 128)]
    assert launch_all() == defaults
    tat._block_cache[key] = (128, 64)
    assert launch_all() == [("fwd", 128, 64), ("dq", 128, 64),
                            ("dkv", 64, 128)]
    tat._block_cache[key] = (64, 128)             # dK/dV's own tile
    assert launch_all() == defaults
    before = dict(fa.launches_by_build)
    tat._block_cache[key] = (96, 96)              # no build's: defaults
    assert launch_all() == defaults
    tat._block_cache[key] = ("x", None)           # rotted: defaults
    assert launch_all() == defaults
    tat._block_cache[key] = (128, 64)
    tat.set_config({"kernel": {"enable": False}})
    assert launch_all() == defaults
    tat.set_config({"kernel": {"enable": True}})
    # counted by build
    assert fa.launches_by_build[("fwd", 128, 128)] - \
        before.get(("fwd", 128, 128), 0) == 3
    # f32 runs its one build whatever the table says
    q32, meta32 = q.float(), fa.Meta(H=H, Hk=H, causal=True, scale=0.125)
    with _mocked_launch(monkeypatch, fa) as lib:
        fa._run("fwd", [q32, q32, q32, None, q32, lse], q32, meta32, None)
    assert _flash_tiles(lib) == [("fwd", 64, 64)]
    # the tuner's path: an explicit pair, not the table's
    with _mocked_launch(monkeypatch, fa) as lib:
        fa._run("fwd", [q, q, q, None, q, lse], q, meta, (128, 64))
    assert _flash_tiles(lib) == [("fwd", 128, 64)]


@pytest.mark.parametrize("T", [1, 5, 64])
def test_table_pair_reaches_the_paged_launch(fresh, monkeypatch, T):
    S, Hh, Dd, bs, nb = 2, 4, 32, 4, 16
    q = torch.zeros((S, T, Hh, Dd))
    pool = torch.zeros((1 + S * nb, bs, Hh, Dd))
    tables = torch.zeros((S, nb), dtype=torch.int32)
    pos = torch.zeros((S,), dtype=torch.int32)
    key = ("paged", "cuda", Hh, nb * bs, Dd, bs)

    def launch():
        with _mocked_launch(monkeypatch, pa) as lib:
            pa._launch(q, pool, pool, tables, pos, 1.0, None, None, 127.0,
                       False, [q, pool, pool, tables, pos])
        fwd = [args for name, args in lib.calls
               if name == "paged_attention_fwd"]
        parts = [args for name, args in lib.calls
                 if name == "paged_attention_partial_floats"]
        libs = [args for name, args in lib.calls if name == "library"]
        assert len(fwd) == 1 and parts[0][-1] == fwd[0][-3]
        split, chunk = fwd[0][-3], fwd[0][-2]
        # the library that holds the build
        assert libs == [(pa.library_of(pa.build_of(T, split, chunk)),)]
        return split, chunk
    assert launch() == (128, 64)
    before = pa.build_counts()
    tat._block_cache[key] = (256, 32)
    assert launch() == (256, 32)
    assert pa.decode_split_keys(Hh, nb * bs, Dd, bs) == 256
    build = pa.build_of(T, 256, 32)
    assert pa.launches_by_build[build] - before.get(build, 0) == 1
    tat._block_cache[key] = (0, -3)               # rotted: defaults
    assert launch() == (128, 64)
    tat._block_cache[key] = (256, 32)
    tat.set_config({"kernel": {"enable": False}})
    assert launch() == (128, 64)
    tat.set_config({"kernel": {"enable": True}})


def test_graph_replay_credits_builds(monkeypatch):
    before = pa.launch_counts(), pa.build_counts()
    pa.count_replay((3, 1, 2), {("tile", 256, 32): 2, ("window", 256): 1})
    assert pa.launch_counts() == tuple(a + b for a, b in
                                       zip(before[0], (3, 1, 2)))
    assert pa.launches_by_build[("tile", 256, 32)] == \
        before[1].get(("tile", 256, 32), 0) + 2
    pa.set_launch_counts(before[0])
    pa.set_build_counts(before[1])
    assert pa.build_counts() == before[1]


# --------------------------------------------- each split, the reference's
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("split", pa.SPLIT_KEYS)
def test_each_split_matches_the_reference(split, quant):
    """`attend_split_plain` at each split the paged kernels are built at,
    decode (T = 1: key counts one below, at and one above each split
    edge, the full table, a pos = -1 slot), against the Pallas kernel in
    interpret mode and the gather oracle at 1e-5, H=4, D=32, bs=4."""
    tpa._check_split_merge(split, 4, quant, 32)


@pytest.mark.parametrize("split", pa.SPLIT_KEYS[1:])
def test_each_split_window_matches_the_reference(split):
    """The window kernel's split (T = 5) at each split but the default
    (`tests/test_torch_paged_attention.py` holds 128's), as above."""
    tpa._check_window_split_merge(5, split, 4, False, 32)


def test_shipped_entries_are_builds():
    """Every "cuda" entry of the shipped table is a pair some build has,
    and the file holds no other backend's."""
    table = tat._read_cache_file(tat._SHIPPED_PATH)
    for key, pair in table.items():
        paged = key[0] == "paged"
        assert (key[1] if paged else key[0]) == "cuda", key
        have = tat._paged_pairs() if paged else tat._flash_pairs()
        assert pair in have, (key, pair)


def test_library_build_lists_match_the_wrappers():
    """The build lists the C sources declare are the wrappers' (the
    libraries check them again when they are bound on the card)."""
    import re
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    csrc = os.path.join(here, "paddle_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "paged_attention.cuh")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))
    assert (const("kSplit"), const("kSplitWide")) == pa.SPLIT_KEYS
    assert (const("kTileKeys"), const("kTileKeysNarrow")) == pa.CHUNK_KEYS
    # one library a PAGED_ATTENTION_BUILDS value, in LIBRARIES' order
    for i, name in enumerate(pa.LIBRARIES):
        lib = open(os.path.join(csrc, name + ".cu")).read()
        assert f"#define PAGED_ATTENTION_BUILDS {i}\n" in lib
    fsrc = open(os.path.join(csrc, "flash_attention.cu")).read()
    body = fsrc[fsrc.index("bool wgmma_built"):]
    body = body[:body.index("\n}\n")]
    for which, cond in (("fwd", "kFwd"), ("dq", "kDq"), ("dkv", "kDkv")):
        line = body[body.index(f"case {cond}:"):]
        line = line[:line.index(";")]
        bm = int(re.search(r"bm == (\d+)", line).group(1))
        bns = [int(x) for x in re.findall(r"bn == (\d+)", line)]
        assert tuple((bm, bn) for bn in bns) == fa.BUILDS[which]
