"""Compile once: an engine's serving executables captured as CUDA graphs.

The JAX engines compile each serving executable once (`decode`,
`prefill[bucket]`, ...) and dispatch it as one program. The port's
counterpart is a CUDA graph per executable: captured once per engine, on
first use or by `precompile()`, and replayed on every later call, so a
decode step costs one graph launch instead of some 440 kernel launches.

A graph reads and writes fixed device addresses, so everything an
executable touches is storage the engine owns and never reallocates: the
KV pools, the weights (a weight swap copies into them), and the int32
inputs in `StaticInputs`, which the host fills and uploads with one copy
before every call. On the CPU the same functions run eagerly over the same
buffers, so the CPU tests hold the discipline the graphs depend on.

Capture protocol (`Executables.capture`):
  1. the inputs are uploaded in a safe state, whose writes land in scratch
     (every table entry the garbage block, every position 0; an engine
     names other fields' safe values), so neither the warm-up nor the
     capture moves serving state;
  2. one eager warm-up on the capture stream: it builds the kernel
     library, sets the kernels' shared-memory attributes and makes the
     paged kernel's ticket counters for that stream, so none of that
     lands inside a graph;
  3. the capture, on the same stream, with Python's cyclic garbage
     collector paused (a collection that frees another graph while this
     one captures invalidates the capture), into a memory pool the engine's
     graphs share. A graph's outputs stay allocated, but another graph's
     temporaries may reuse their memory, so an output is valid until the
     next replay of any of the engine's graphs (the engine reads each at
     once, and hands values between graphs only through its own
     buffers). Replays run one at a time, in order, on one stream; the
     paged kernel's tickets belong to the capture stream, which is one
     more reason they must not overlap.

Numerics taps: an armed engine's executable also returns its sink, the
stats of its tap sites stacked in the graph into one tensor (behind the
greedy picks or the verify result), which the engine copies to the host
right after the replay with the read the step makes anyway. The warm-up's
and the capture's outputs are never read, so a safe-state run never
reaches the engine's monitor.

Launch counts: a replay runs no Python, so the paged kernel wrapper's
counters (`ops.paged_attention.launches`, ...) cannot count its launches.
The launches a capture records are credited to those counters once per
replay, and the warm-up's and the capture's own calls are not counted.

Profiling: while a torch profiler records, each replay runs inside a
`graph::<name>` range, so `observability.deviceprof` names the
executable its kernels belong to (their `hlo_module`).

A capture that fails raises; there is no eager fallback on the card.
"""
import gc

import numpy as np
import torch

from ..ops import paged_attention as _pa

__all__ = ["StaticInputs", "Executables"]


def _replay(name, graph):
    """Replay `graph`, labelled `graph::<name>` while a torch profiler
    records."""
    if torch.autograd._profiler_enabled():
        with torch.profiler.record_function(f"graph::{name}"):
            graph.replay()
    else:
        graph.replay()


class StaticInputs:
    """Named int32 input arrays of a family of executables, packed in one
    host vector and one device vector. `host[name]` are numpy views the
    engine keeps its state in; `dev[name]` the device views the
    executables read; `upload()` copies the whole vector in one
    synchronous copy (from pageable memory, so the host may rewrite its
    arrays as soon as it returns)."""

    def __init__(self, shapes, device):
        size = sum(int(np.prod(s)) for s in shapes.values())
        self._host = np.zeros((size,), np.int32)
        self._dev = torch.zeros((size,), dtype=torch.int32, device=device)
        self.host, self.dev = {}, {}
        off = 0
        for name, shape in shapes.items():
            n = int(np.prod(shape))
            self.host[name] = self._host[off:off + n].reshape(shape)
            self.dev[name] = self._dev[off:off + n].view(shape)
            off += n

    def upload(self, safe=None):
        """Copy the host state to the device; with `safe` ({name: value}),
        upload zeros with those fields set to their value instead (the
        capture's safe state), leaving the host state as it is."""
        src = self._host
        if safe is not None:
            src = np.zeros_like(self._host)
            off = 0
            for name, arr in self.host.items():
                if name in safe:
                    src[off:off + arr.size] = safe[name]
                off += arr.size
        self._dev.copy_(torch.from_numpy(src))


class Executables:
    """One engine's executables by name. On the card each is a CUDA graph
    captured at most once and replayed; on the CPU each runs eagerly.
    `capture_counts[name]` counts captures, as the JAX engines'
    `trace_counts` count traces. An executable runs on the engine's
    device unless its calls name another (`device=`: a pipeline stage's),
    which gets a capture stream and a graph memory pool of its own."""

    def __init__(self, device):
        self.device = device
        self.capture_counts = {}
        self._graphs = {}            # name -> (graph, outputs, launches,
                                     # launches by build)
        self._streams = {}           # device -> (capture stream, pool)

    def run(self, name, fn, inputs, safe=None, upload=True, device=None):
        """Upload `inputs` and run executable `name` (`fn` computes it over
        the engine's static storage). upload=False: the inputs are on the
        device as the previous call uploaded them (a capture made now
        uploads them again). Returns (outputs, paged-kernel launches the
        call made)."""
        if (device or self.device).type != "cuda":
            if upload:
                inputs.upload()
            return fn(), 0
        if name not in self._graphs:
            upload = True                # the capture left the safe state
        graph, out, launches, builds = self.capture(name, fn, inputs, safe,
                                                    device)
        if upload:
            inputs.upload()
        _replay(name, graph)
        _pa.count_replay(launches, builds)
        return out, launches[0]

    def replay(self, name):
        """Replay a captured graph over the inputs as they were last
        uploaded; returns its outputs."""
        graph, out, launches, builds = self._graphs[name]
        _replay(name, graph)
        _pa.count_replay(launches, builds)
        return out

    def invalidate(self, name):
        """Drop `name`'s graph if it was captured: its next call captures
        it again (and counts the capture). Used when the storage the graph
        reads is replaced, as when an engine attaches an adapter bank."""
        self._graphs.pop(name, None)

    def capture(self, name, fn, inputs, safe=None, device=None):
        """Capture `name` unless it was (see the module docstring); returns
        (graph, outputs, launch counts of one replay, its launches by
        build)."""
        entry = self._graphs.get(name)
        if entry is not None:
            return entry
        device = device or self.device
        key = str(device)
        if key not in self._streams:
            with torch.cuda.device(device):
                self._streams[key] = (torch.cuda.Stream(device=device),
                                      torch.cuda.graph_pool_handle())
        stream, pool = self._streams[key]
        counts, by_build = _pa.launch_counts(), _pa.build_counts()
        current = torch.cuda.current_stream(device)
        inputs.upload(safe or {})
        stream.wait_stream(current)
        with torch.cuda.device(device), torch.cuda.stream(stream):
            fn()
        current.wait_stream(stream)
        warm, warm_builds = _pa.launch_counts(), _pa.build_counts()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(device), torch.cuda.graph(
                    graph, pool=pool, stream=stream):
                out = fn()
        finally:
            if collecting:
                gc.enable()
        launches = tuple(c - w for c, w in zip(_pa.launch_counts(), warm))
        builds = {b: n - warm_builds.get(b, 0)
                  for b, n in _pa.build_counts().items()
                  if n != warm_builds.get(b, 0)}
        _pa.set_launch_counts(counts)
        _pa.set_build_counts(by_build)
        self.capture_counts[name] = self.capture_counts.get(name, 0) + 1
        entry = (graph, out, launches, builds)
        self._graphs[name] = entry
        return entry
