"""The port's persistent compile cache (`framework/compile_cache.py`) and
the kernel build through it (`_kernels/build.py`), on the CPU.

The port's versions of the reference's passing cache cases
(`tests/test_compile_cache.py`): a torn write injected through the
`checkpoint.write` site never commits; SIGKILL inside the commit window
leaves no entry and the next commit sweeps the tempdir; a truncated or
bit-rotted entry fails its manifest check, is deleted and recommitted;
an entry whose metadata names another format version is rejected; the
retention cap evicts the least recently used entry. Then the port's own:
`invalidate_active`, the four metric families, a commit discarded when
another process committed the entry first, and `build_all` with a fake
`nvcc` on PATH (a script that writes bytes and logs each call): the cold
process misses every library and builds each once, a second process hits
all of them with no compile call, an edited `.cu` or other flags rebuild
only what they change, another compiler's entry is rebuilt, a torn commit
still hands back a library, and a failed compile raises with the
compiler's output. A directory shared with the JAX package's cache keeps
both packages' entries under their caps.
"""
import json
import os
import shutil
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from paddle_tpu_torch._kernels import build
from paddle_tpu_torch.framework import ckpt_commit
from paddle_tpu_torch.framework import compile_cache as cc
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.observability import faults
from paddle_tpu_torch.observability import metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    # no global cache during a test, and the process's own put back after
    monkeypatch.setattr(cc, "_ACTIVE", None)
    yield
    faults.disarm_all()


def _put(cache, name, payload=b"library bytes", parts=("v1",)):
    """Commit an entry holding one data file; returns (dirname, digest,
    committed)."""
    dirname, digest = cache.entry_key(name, parts)

    def write(tmp):
        with open(os.path.join(tmp, "lib.so"), "wb") as f:
            f.write(payload)
    return dirname, digest, cache.store(name, dirname, digest, write, 0.5)


def _read(entry):
    with open(os.path.join(entry, "lib.so"), "rb") as f:
        return f.read()


def test_entry_key_is_content_addressed(tmp_path):
    cache = cc.CompileCache(str(tmp_path))
    a = cache.entry_key("libx", ("src-1", ("-O3",)))
    assert a == cache.entry_key("libx", ("src-1", ("-O3",)))
    assert a[0] != cache.entry_key("libx", ("src-2", ("-O3",)))[0]
    assert a[0] != cache.entry_key("libx", ("src-1", ("-O2",)))[0]
    assert a[0].startswith("libx.")


def test_injected_torn_write_never_commits(tmp_path):
    cache = cc.CompileCache(str(tmp_path))
    faults.arm("checkpoint.write", mode="truncate", nth=1)
    with pytest.warns(UserWarning, match="commit .* failed|not persisted"):
        dirname, digest, ok = _put(cache, "t.torn")
    assert ok is False
    assert cache.entries() == []
    assert cache.stats["uncacheable"] == 1
    faults.disarm_all()
    # with the fault gone the same entry commits and then hits
    dirname, digest, ok = _put(cache, "t.torn")
    assert ok and len(cache.entries()) == 1
    entry = cache.lookup("t.torn", dirname, digest)
    assert _read(entry) == b"library bytes"
    assert cache.stats["hits"] == 1


def test_sigkill_mid_commit_recovers(tmp_path):
    cache_dir = str(tmp_path / "cache")
    entries_dir = os.path.join(cache_dir, cc.SUBDIR)
    script = textwrap.dedent(f"""
        import os
        from paddle_tpu_torch.framework import compile_cache as cc
        cache = cc.CompileCache({cache_dir!r})
        d, g = cache.entry_key("t.kill", ("v1",))
        def write(tmp):
            with open(os.path.join(tmp, "lib.so"), "wb") as f:
                f.write(b"library bytes")
        print("READY", flush=True)
        cache.store("t.kill", d, g, write)   # held open in the window
        print("DONE", flush=True)
        """)
    env = dict(os.environ,
               PTN_FAULTS="checkpoint.write=delay:delay=120:max=1")
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    try:
        assert proc.stdout.readline().strip() == "READY"
        deadline = time.time() + 120
        while time.time() < deadline:
            if os.path.isdir(entries_dir) and any(
                    n.startswith(".") and ".tmp." in n
                    for n in os.listdir(entries_dir)):
                break
            time.sleep(0.05)
        time.sleep(0.3)                # inside the held-open window
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -signal.SIGKILL
    # the survivor sees no entry: a clean miss, then a commit
    cache = cc.CompileCache(cache_dir)
    assert cache.entries() == []
    dirname, digest = cache.entry_key("t.kill", ("v1",))
    assert cache.lookup("t.kill", dirname, digest) is None
    _put(cache, "t.kill")
    assert cache.stats == {"hits": 0, "misses": 1, "bypass": 0,
                           "corrupt": 0, "uncacheable": 0, "evicted": 0,
                           "discarded": 0}
    assert len(cache.entries()) == 1
    # the dead child's hidden tempdir was swept by the commit
    assert not any(n.startswith(".") and ".tmp." in n
                   for n in os.listdir(entries_dir))


@pytest.mark.parametrize("damage", ["truncate", "bitrot"])
def test_damaged_entry_misses_and_recommits(tmp_path, damage):
    cache = cc.CompileCache(str(tmp_path))
    dirname, digest, _ = _put(cache, "t.rot", payload=b"0123456789" * 50)
    victim = os.path.join(cache.path, dirname, "lib.so")
    with open(victim, "r+b") as f:
        if damage == "truncate":
            f.truncate(100)
        else:
            f.seek(123)
            f.write(b"X")
    opened = []
    with pytest.warns(UserWarning, match="failed verification"):
        got = cache.lookup("t.rot", dirname, digest,
                           loader=lambda d, m: opened.append(d))
    # the manifest check ran before anything opened the file
    assert got is None and opened == []
    assert cache.stats["corrupt"] == 1 and cache.stats["misses"] == 1
    assert cache.entries() == []
    _put(cache, "t.rot", payload=b"0123456789" * 50)
    entry = cache.lookup("t.rot", dirname, digest)
    assert _read(entry) == b"0123456789" * 50


def test_version_skew_entry_rejected(tmp_path):
    cache = cc.CompileCache(str(tmp_path))
    dirname, digest, _ = _put(cache, "t.skew")
    full = os.path.join(cache.path, dirname)
    with open(os.path.join(full, cc.ENTRY_META)) as f:
        meta = json.load(f)
    assert meta["format_version"] == cc.FORMAT_VERSION
    assert meta["fingerprint"] == cc.framework_fingerprint()
    meta["format_version"] = cc.FORMAT_VERSION + 1
    # recommitted THROUGH the protocol: the manifest verifies, only the
    # metadata names another format
    with ckpt_commit.atomic_commit(full) as tmp:
        with open(os.path.join(tmp, cc.ENTRY_META), "w") as f:
            json.dump(meta, f)
        shutil.copy2(os.path.join(full, "lib.so"), os.path.join(tmp, "lib.so"))
    with pytest.warns(UserWarning, match="failed to load"):
        assert cache.lookup("t.skew", dirname, digest) is None
    assert cache.stats["corrupt"] == 1
    assert cache.entries() == []
    # a caller's check rejects the same way
    dirname, digest, _ = _put(cache, "t.skew")

    def check(meta):
        raise ValueError("built by another compiler")
    with pytest.warns(UserWarning, match="another compiler"):
        assert cache.lookup("t.skew", dirname, digest, check=check) is None
    assert cache.stats["corrupt"] == 2


def test_retention_cap_evicts_lru_by_mtime(tmp_path):
    cache = cc.CompileCache(str(tmp_path), max_entries=3)
    keys = []
    for i in range(3):
        keys.append(_put(cache, "t.ret", parts=(i,))[:2])
        time.sleep(0.05)               # distinct mtimes
    assert len(cache.entries()) == 3
    # a hit on v=0 makes it the most recently used
    assert cache.lookup("t.ret", *keys[0]) is not None
    time.sleep(0.05)
    keys.append(_put(cache, "t.ret", parts=(3,))[:2])   # evicts v=1
    time.sleep(0.05)
    keys.append(_put(cache, "t.ret", parts=(4,))[:2])   # evicts v=2
    assert len(cache.entries()) == 3
    assert cache.stats["evicted"] == 2
    assert cache.lookup("t.ret", *keys[0]) is not None
    assert cache.lookup("t.ret", *keys[1]) is None
    assert cache.lookup("t.ret", *keys[2]) is None
    saved = dict(tflags._FLAGS)
    tflags.set_flags({"FLAGS_compile_cache_max_entries": 7})
    try:
        assert cc.CompileCache(str(tmp_path)).max_entries == 7
    finally:
        tflags._FLAGS.update(saved)
    assert cc.CompileCache(str(tmp_path)).max_entries == 0  # unlimited


def test_a_directory_shared_with_the_jax_cache_keeps_both(tmp_path):
    """The JAX package reads the same FLAGS_compile_cache_dir: under one
    directory and a cap of one entry each, neither package's commits
    evict the other's entries."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.framework import compile_cache as jcc
    shared = str(tmp_path)
    jcache = jcc.CompileCache(shared, max_entries=1)
    cache = cc.CompileCache(shared, max_entries=1)
    compiled = jax.jit(lambda x: x * 2.0).lower(jnp.ones(4)).compile()

    def jput(i):
        dirname, digest = jcache.entry_key("t.jax", (i,))
        assert jcache.store("t.jax", dirname, digest, compiled, None, 0.1)
        return dirname
    j0 = jput(0)
    p0 = _put(cache, "t.port", parts=(0,))[0]
    assert jcache.entries() == [j0] and cache.entries() == [p0]
    time.sleep(0.05)
    p1 = _put(cache, "t.port", parts=(1,))[0]      # evicts p0 only
    time.sleep(0.05)
    j1 = jput(1)                                   # evicts j0 only
    assert jcache.entries() == [j1] and cache.entries() == [p1]
    assert cache.stats["evicted"] == 1 and jcache.stats["evicted"] == 1
    assert cache.lookup("t.port", *cache.entry_key("t.port", (1,))) \
        is not None
    cache.clear()
    assert cache.entries() == [] and jcache.entries() == [j1]


def test_invalidate_active_bypasses_older_entries(tmp_path):
    assert cc.active() is None
    cc.invalidate_active()             # no cache attached: a no-op
    cache = cc.attach(str(tmp_path))
    assert cc.active() is cache
    dirname, digest, _ = _put(cache, "t.inv")
    assert cache.lookup("t.inv", dirname, digest) is not None
    time.sleep(0.01)
    cc.invalidate_active()
    assert cache.lookup("t.inv", dirname, digest) is None
    assert cache.stats["bypass"] == 1
    time.sleep(0.01)
    _put(cache, "t.inv")               # recommitted after the stamp
    assert cache.lookup("t.inv", dirname, digest) is not None
    # a fresh process sees every entry again
    fresh = cc.CompileCache(str(tmp_path))
    assert fresh.lookup("t.inv", dirname, digest) is not None
    cc.detach()
    assert cc.active() is None


def test_metric_families(tmp_path):
    reg = metrics.registry()

    def hist_count(name, label):
        snap = reg.snapshot()
        fam = next(f for f in snap["metrics"] if f["name"] == name)
        return sum(s["count"] for s in fam["samples"]
                   if s["labels"].get("executable") == label)
    hits = reg.counter("compile_cache_hits_total").value
    misses = reg.counter("compile_cache_misses_total").value
    compiles = hist_count("compile_cache_compile_seconds", "t.met")
    loads = hist_count("compile_cache_load_seconds", "t.met")
    cache = cc.CompileCache(str(tmp_path))
    dirname, digest = cache.entry_key("t.met", ("v1",))
    assert cache.lookup("t.met", dirname, digest) is None
    _put(cache, "t.met")
    assert cache.lookup("t.met", dirname, digest) is not None
    assert reg.counter("compile_cache_hits_total").value == hits + 1
    assert reg.counter("compile_cache_misses_total").value == misses + 1
    assert hist_count("compile_cache_compile_seconds", "t.met") == \
        compiles + 1
    assert hist_count("compile_cache_load_seconds", "t.met") == loads + 1


def test_commit_after_another_process_committed_is_discarded(tmp_path):
    cache = cc.CompileCache(str(tmp_path))
    dirname, digest = cache.entry_key("t.race", ("v1",))
    pending = cache.begin("t.race", dirname, digest)
    with open(os.path.join(pending.tmp, "lib.so"), "wb") as f:
        f.write(b"second")
    # meanwhile another process commits the same entry: its own tempdir,
    # manifest, and a rename onto the entry's name
    other = str(tmp_path / "other")
    with ckpt_commit.atomic_commit(other) as tmp:
        with open(os.path.join(tmp, "lib.so"), "wb") as f:
            f.write(b"first")
        with open(os.path.join(tmp, cc.ENTRY_META), "w") as f:
            json.dump({"schema": cc.ENTRY_SCHEMA, "digest": digest,
                       "format_version": cc.FORMAT_VERSION}, f)
    os.rename(other, os.path.join(cache.path, dirname))
    assert pending.commit(1.0) is False
    assert cache.stats["discarded"] == 1
    assert _read(cache.lookup("t.race", dirname, digest)) == b"first"
    assert not any(".tmp." in n for n in os.listdir(cache.path))


# ------------------------------------------------- the build, fake nvcc

FAKE_NVCC = r"""#!/usr/bin/env python3
import os, sys
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\n")
if "--version" in sys.argv:
    print(os.environ.get("FAKE_NVCC_VERSION", "fake nvcc 1.0"))
    sys.exit(0)
if os.environ.get("FAKE_NVCC_FAIL"):
    print("error: fake compiler refuses " + sys.argv[-1])
    sys.exit(2)
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "wb") as f:
    f.write(b"ELF " + open(sys.argv[-1], "rb").read()[:64])
print("ptxas info    : Used 10 registers, 0 bytes spill stores")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A fake nvcc first on PATH, logging to `log`; the build module's
    process state reset, and its csrc a copy under tmp_path."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    exe = bindir / "nvcc"
    exe.write_text(FAKE_NVCC)
    exe.chmod(0o755)
    log = tmp_path / "nvcc.log"
    log.write_text("")
    csrc = tmp_path / "csrc"
    shutil.copytree(build._CSRC, str(csrc))
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(build, "_CSRC", str(csrc))
    _reset_build(monkeypatch)

    def compiles():
        return [ln for ln in log.read_text().splitlines() if " -o " in ln]
    return {"log": log, "csrc": csrc, "compiles": compiles,
            "cache": str(tmp_path / "cache")}


def _reset_build(monkeypatch):
    for name in ("_loaded", "_outcome", "_paths", "_private"):
        monkeypatch.setattr(build, name, {})
    monkeypatch.setattr(build, "_toolkit_version", [])


def test_build_all_cold_then_warm_process(fake_nvcc):
    cache = cc.CompileCache(fake_nvcc["cache"])
    libs = build.build_all(cache=cache)
    names = sorted(build.sources())
    assert sorted(libs) == names and len(names) >= 2
    assert {build.outcome(n) for n in names} == {"miss"}
    assert cache.stats["misses"] == len(names) and cache.stats["hits"] == 0
    assert len(fake_nvcc["compiles"]()) == len(names)
    for n, path in libs.items():
        assert os.path.dirname(path) in [os.path.join(cache.path, e)
                                         for e in cache.entries()]
        assert "Used 10 registers" in build.ptxas_report(n)
    # a second process: every library a hit, no compile call
    before = len(fake_nvcc["compiles"]())
    code = textwrap.dedent(f"""
        import json
        from paddle_tpu_torch._kernels import build
        from paddle_tpu_torch.framework import compile_cache as cc
        build._CSRC = {str(fake_nvcc['csrc'])!r}
        cache = cc.CompileCache({cache.root!r})
        libs = build.build_all(cache=cache)
        print(json.dumps({{"libs": libs, "stats": cache.stats,
                          "outcome": {{n: build.outcome(n) for n in libs}}}}))
        """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    warm = json.loads(r.stdout.strip().splitlines()[-1])
    assert warm["libs"] == libs
    assert set(warm["outcome"].values()) == {"hit"}
    assert warm["stats"]["hits"] == len(names)
    assert warm["stats"]["misses"] == 0
    assert len(fake_nvcc["compiles"]()) == before


def test_build_key_follows_sources_and_flags(fake_nvcc, monkeypatch):
    cache = cc.CompileCache(fake_nvcc["cache"])
    first = build.build_all(cache=cache)
    n0 = len(fake_nvcc["compiles"]())
    # an edited .cu rebuilds its library only
    cu = fake_nvcc["csrc"] / "paged_attention.cu"
    cu.write_text(cu.read_text() + "\n// edited\n")
    _reset_build(monkeypatch)
    second = build.build_all(cache=cache)
    new = fake_nvcc["compiles"]()[n0:]
    assert len(new) == 1 and new[0].endswith("paged_attention.cu")
    assert second["paged_attention"] != first["paged_attention"]
    assert second["flash_attention"] == first["flash_attention"]
    # an edited header is a source of every library
    hdr = fake_nvcc["csrc"] / "hopper.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    _reset_build(monkeypatch)
    build.build_all(cache=cache)
    assert len(fake_nvcc["compiles"]()) == n0 + 1 + n0
    # other flags: every library misses
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    _reset_build(monkeypatch)
    build.build_all(cache=cache)
    assert len(fake_nvcc["compiles"]()) == n0 + 1 + 2 * n0
    # an entry built by another nvcc is rebuilt where a compiler is found
    monkeypatch.setenv("FAKE_NVCC_VERSION", "fake nvcc 2.0")
    _reset_build(monkeypatch)
    with pytest.warns(UserWarning, match="another nvcc"):
        build.build_all(cache=cache)
    assert len(fake_nvcc["compiles"]()) == n0 + 1 + 3 * n0


def test_torn_build_commit_still_gives_the_library(fake_nvcc):
    cache = cc.CompileCache(fake_nvcc["cache"])
    faults.arm("checkpoint.write", mode="truncate", max_fires=1)
    with pytest.warns(UserWarning, match="not persisted"):
        libs = build.build_all(cache=cache)
    torn = [n for n, p in libs.items() if ".keep." in p]
    assert len(torn) == 1
    name = torn[0]
    keep = os.path.dirname(libs[name])
    # the private copy was taken before the torn commit: whole, with its
    # compiler report beside it
    src = build.sources()[name]
    with open(libs[name], "rb") as f, open(src, "rb") as g:
        assert f.read() == b"ELF " + g.read()[:64]
    assert "Used 10 registers" in build.ptxas_report(name)
    assert cache.stats["uncacheable"] == 1
    assert len(cache.entries()) == len(libs) - 1
    # the process reuses it: no second compile, whichever call asks
    n = len(fake_nvcc["compiles"]())
    assert build.build_all(cache=cache)[name] == libs[name]
    assert build._resolve([name], cache)[name] == libs[name]
    assert len(fake_nvcc["compiles"]()) == n
    build._drop_private()          # what the process does at exit
    assert not os.path.exists(keep)


def test_failed_compile_raises_with_the_output(fake_nvcc, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    cache = cc.CompileCache(fake_nvcc["cache"])
    with pytest.raises(RuntimeError, match="fake compiler refuses"):
        build.build_all(cache=cache)
    assert cache.entries() == []
    assert not any(".tmp." in n for n in os.listdir(cache.path))


def test_build_resolves_private_then_global_then_default(tmp_path):
    private = cc.CompileCache(str(tmp_path / "private"))
    assert build.resolve_cache(private) is private
    default = build.resolve_cache()
    assert default.path == build.build_dir()
    glob = cc.attach(str(tmp_path / "global"))
    assert build.resolve_cache() is glob
    assert build.resolve_cache(private) is private
