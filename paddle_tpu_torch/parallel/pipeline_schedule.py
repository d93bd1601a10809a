"""Pipeline schedules as static tick tables.

A copy of `paddle_tpu/parallel/pipeline_schedule.py` (plain numpy, no JAX):
the pipeline-parallel serving engines (`serving/distributed/pp.py`) walk
`build_serving_tables`; the training half of the port reuses the rest.
The reference's notes follow.

The reference hand-codes its schedules in Python control flow over p2p sends
(fleet/meta_parallel/pipeline_parallel.py:120 1F1B, :464 interleaved). On TPU
the whole pipeline is ONE compiled program: a lax.scan over "ticks" where
every tick each pp stage (optionally) runs one microbatch forward and one
microbatch backward, hand-off via ppermute. Which (stage, tick) pair runs
which microbatch is decided HERE, ahead of time, by simulating the schedule
in plain Python; the result is a pair of int32 tables

    fwd_tbl[t, s] = microbatch whose FORWARD stage s runs at tick t (-1 none)
    bwd_tbl[t, s] = microbatch whose BACKWARD stage s runs at tick t (-1 none)

which the compiled scan merely indexes. Any schedule expressible as such
tables (GPipe, 1F1B, eager-1F1B, interleaved virtual stages) compiles to the
same scan body — schedule choice costs nothing at runtime.

Correctness constraints enforced by the simulator:
- F of microbatch j at stage s needs F(j, s-1) at an earlier tick (activation
  ppermuted between ticks); stage 0 sources from the embedded input.
- B of j at stage s needs B(j, s+1) at an earlier tick; the LAST stage needs
  F(j, last) at an earlier-or-equal tick (the tick body runs F before B, so
  the last stage may fold F_j and B_j into one tick — classic 1F1B).
- in-flight microbatches at stage s (F done, B not) never exceed cap(s);
  cap = pp - s gives the 1F1B activation bound, cap = M gives GPipe.
"""
import numpy as np


def simulate_schedule(n_microbatches, pp, cap, max_ticks=100000):
    """Generic event-driven simulator -> (fwd_tbl, bwd_tbl) int32 (T, pp).

    cap: callable stage -> max in-flight microbatches at that stage.
    Every stage greedily runs (at most) one F and one B per tick subject to
    the availability rules above; B preferred implicitly since capacity only
    blocks F.
    """
    M = n_microbatches
    fwd_done = np.full((pp, M), -1, np.int64)   # tick F(j,s) completed
    bwd_done = np.full((pp, M), -1, np.int64)
    nf = [0] * pp
    nb = [0] * pp
    rows_f, rows_b = [], []
    t = 0
    while any(n < M for n in nb) and t < max_ticks:
        row_f = [-1] * pp
        row_b = [-1] * pp
        # Decide per stage: B first (it frees capacity for the same-tick F of
        # the steady state), then F against post-B occupancy. The compiled
        # body still EXECUTES F before B within a tick — that transiently
        # holds cap+1 activations, which is why the buffer has cap+1 slots —
        # and the last stage may fold F_j and B_j into one tick.
        for s in range(pp):
            # forward availability (independent of this tick's B)
            j = nf[s]
            avail_f = j < M and ((s == 0) or (0 <= fwd_done[s - 1][j] < t))
            b = nb[s]
            if b < M:
                if s == pp - 1:
                    ok = (0 <= fwd_done[s][b] < t) or (b == j and avail_f)
                else:
                    ok = 0 <= bwd_done[s + 1][b] < t
                if ok:
                    row_b[s] = b
                    bwd_done[s][b] = t
                    nb[s] += 1
            if avail_f and (nf[s] - nb[s]) < cap(s):
                row_f[s] = j
                fwd_done[s][j] = t
                nf[s] += 1
        rows_f.append(row_f)
        rows_b.append(row_b)
        t += 1
    if any(n < M for n in nb):
        raise RuntimeError(
            f"schedule deadlock: M={M} pp={pp} cap={[cap(s) for s in range(pp)]}")
    return (np.asarray(rows_f, np.int32), np.asarray(rows_b, np.int32))


def build_tables(n_microbatches, pp, schedule="1f1b"):
    """-> (fwd_tbl, bwd_tbl, buffer_slots).

    schedule:
      "1f1b"      cap(s) = pp - s: the 1F1B live-activation bound; steady
                  state alternates one B and one F per stage per tick.
      "eager1f1b" cap 2*pp: every stage forwards as fast as activations
                  arrive (shorter warmup, ~2x the 1F1B activation memory,
                  still O(pp) and independent of M).
      "gpipe"     cap M: all forwards first; activation memory grows with M.
                  (Exists for comparison/tests; prefer "1f1b".)
    """
    M, caps = n_microbatches, None
    if schedule == "1f1b":
        caps = lambda s: pp - s
    elif schedule == "eager1f1b":
        caps = lambda s: 2 * pp
    elif schedule == "gpipe":
        caps = lambda s: M
    else:
        raise ValueError(f"unknown pipeline schedule {schedule!r}; "
                         "expected 1f1b | eager1f1b | gpipe")
    fwd_tbl, bwd_tbl = simulate_schedule(M, pp, caps)
    max_inflight = max(caps(s) for s in range(pp))
    slots = min(M, max_inflight) + 1
    return fwd_tbl, bwd_tbl, slots


def build_interleaved_tables(n_microbatches, pp, vpp):
    """Interleaved virtual stages (Megatron-style; reference
    pipeline_parallel.py:464). Device s hosts vpp chunks; chunk c on device s
    is virtual stage k = c*pp + s. Returns (fwd_tbl, bwd_tbl, slots) with
    shape (T, pp, vpp): the tick table per device per chunk.

    The simulator treats the D = vpp*pp virtual stages as one deep pipeline
    (correctness rules identical), with the extra constraint that a physical
    device runs at most one F and one B per tick ACROSS its chunks — a tick
    is one microbatch-stage of work, so wall-clock per tick stays constant.
    Chunk-depth-first priority (lowest virtual stage first for B, for F the
    chunk whose turn sustains the 1F1B steady state) reproduces the
    interleaved schedule's reduced warmup bubble.
    """
    M, D = n_microbatches, vpp * pp
    fwd_done = np.full((D, M), -1, np.int64)
    bwd_done = np.full((D, M), -1, np.int64)
    nf = [0] * D
    nb = [0] * D
    rows_f, rows_b = [], []
    # per-device in-flight cap: 1F1B bound generalized to interleave — device
    # s may hold up to D - s in-flight (its earliest chunk's bound dominates)
    dev_cap = [D - s for s in range(pp)]
    t = 0
    while any(n < M for n in nb) and t < 200000:
        row_f = np.full((pp, vpp), -1, np.int64)
        row_b = np.full((pp, vpp), -1, np.int64)
        for s in range(pp):
            # one F slot: pick the READY chunk with the fewest forwards done
            # (breadth-first over chunks = Megatron's interleave order)
            inflight = sum(nf[c * pp + s] - nb[c * pp + s] for c in range(vpp))
            if inflight < dev_cap[s]:
                best = None
                for c in range(vpp):
                    k = c * pp + s
                    j = nf[k]
                    if j >= M:
                        continue
                    ok = (k == 0) or (0 <= fwd_done[k - 1][j] < t)
                    if ok and (best is None or nf[k] < nf[best[0] * pp + s] or
                               (nf[k] == nf[best[0] * pp + s] and c < best[0])):
                        best = (c, j)
                if best is not None:
                    c, j = best
                    k = c * pp + s
                    row_f[s, c] = j
                    fwd_done[k][j] = t
                    nf[k] += 1
        for s in range(pp):
            # one B slot: pick the ready chunk with the DEEPEST virtual stage
            # (drain from the end of the pipeline first)
            for c in reversed(range(vpp)):
                k = c * pp + s
                b = nb[k]
                if b >= M:
                    continue
                if k == D - 1:
                    ok = 0 <= fwd_done[k][b] <= t
                else:
                    ok = 0 <= bwd_done[k + 1][b] < t
                if ok:
                    row_b[s, c] = b
                    bwd_done[k][b] = t
                    nb[k] += 1
                    break
        rows_f.append(row_f)
        rows_b.append(row_b)
        t += 1
    if any(n < M for n in nb):
        raise RuntimeError(f"interleaved schedule deadlock: M={M} pp={pp} vpp={vpp}")
    fwd_tbl = np.stack(rows_f).astype(np.int32)
    bwd_tbl = np.stack(rows_b).astype(np.int32)
    slots = min(M, max(dev_cap)) + 1
    return fwd_tbl, bwd_tbl, slots


def arrival_tables(fwd_tbl, bwd_tbl, pp, vpp):
    """When does each (device, chunk) RECEIVE work over the ppermute rings?

    The fwd/bwd channels are overwritten every tick, so arriving activations
    and cotangents must be parked in buffers the tick they arrive (a stage may
    not run them until later — schedule stalls). Arrival times are static:

      farr[t, s, c] = microbatch whose forward ACTIVATION arrives at tick t
                      (sent by the predecessor virtual stage at t-1), -1 none
      garr[t, s, c] = microbatch whose COTANGENT arrives at tick t, -1 none

    Virtual-stage ring: predecessor of (s, c) is (s-1, c); for s == 0 it is
    (pp-1, c-1) (chunk wrap). Virtual stage 0 (s=0, c=0) embeds its own input;
    the last virtual stage seeds its own cotangent from the loss.
    """
    T = fwd_tbl.shape[0]
    farr = np.full((T, pp, vpp), -1, np.int32)
    garr = np.full((T, pp, vpp), -1, np.int32)
    for s in range(pp):
        for c in range(vpp):
            if not (s == 0 and c == 0):
                ps, pc = (s - 1, c) if s > 0 else (pp - 1, c - 1)
                farr[1:, s, c] = fwd_tbl[:-1, ps, pc]
            if not (s == pp - 1 and c == vpp - 1):
                ns, nc = (s + 1, c) if s < pp - 1 else (0, c + 1)
                garr[1:, s, c] = bwd_tbl[:-1, ns, nc]
    return farr, garr


def required_slots(fwd_tbl, bwd_tbl, farr, garr, n_microbatches, pp, vpp):
    """Circular-buffer size: max microbatches simultaneously LIVE at any
    (device, chunk) — live from arrival (or forward, whichever first) until
    backward completes — so slot j % W never collides."""
    T = fwd_tbl.shape[0]
    M = n_microbatches
    worst = 1
    for s in range(pp):
        for c in range(vpp):
            start = np.full(M, T, np.int64)
            g_start = np.full(M, T, np.int64)
            end = np.zeros(M, np.int64)
            for t in range(T):
                for tbl, rec in ((fwd_tbl, start), (farr, start),
                                 (garr, g_start)):
                    j = tbl[t, s, c]
                    if j >= 0:
                        rec[j] = min(rec[j], t)
                j = bwd_tbl[t, s, c]
                if j >= 0:
                    end[j] = t
                    g_start[j] = min(g_start[j], t)
            for st in (start, g_start):
                for t in range(T):
                    live = int(((st <= t) & (end >= t)).sum())
                    worst = max(worst, live)
    return worst + 1


def build_serving_tables(n_microbatches, pp, tokens_per_tick=1):
    """Forward-only tick table for SERVING pipelines: the
    1F1B machinery above minus the backward half — microbatch g enters
    stage 0 at tick g and rides the stage ring one hop per tick, so

        tbl[t, s] = microbatch stage s processes at tick t (-1 idle)

    over T = M + pp - 1 ticks. After the (pp-1)-tick fill every stage
    works every tick (the steady-state ring); the only idle entries are
    the fill/drain triangles, so the schedule's bubble fraction is
    (pp-1)/(M + pp - 1) — shrinking with the microbatch count, which is
    what `serving_pp_bubble_fraction` gauges and the metrics_report
    failure-class rule watch.

    tokens_per_tick: W > 1 grows a third dimension — each
    (tick, stage) cell carries the W token slots of its microbatch's
    verify window (a speculative γ+1-token window riding the ring):

        tbl[t, s, w] = global token slot g * W + w (-1 idle)

    Same T, same fill/drain triangles — but one ring pass now moves up
    to M·W tokens instead of M, so the fill/drain cost AMORTIZES per
    emitted token by the window width: idle stage-ticks per emitted
    token fall from (pp-1)·pp/M to (pp-1)·pp/(M·W·rate), where `rate`
    is the fraction of window tokens the verify rule accepts. That
    amortization is the spec×pp composition's second win next to the
    per-verify token multiplier."""
    M, pp = int(n_microbatches), int(pp)
    W = int(tokens_per_tick)
    if M < 1 or pp < 1 or W < 1:
        raise ValueError(f"need M >= 1, pp >= 1 and tokens_per_tick >= 1, "
                         f"got M={M} pp={pp} W={W}")
    T = M + pp - 1
    if W == 1:
        tbl = np.full((T, pp), -1, np.int32)
        for t in range(T):
            for s in range(pp):
                g = t - s
                if 0 <= g < M:
                    tbl[t, s] = g
        return tbl
    tbl = np.full((T, pp, W), -1, np.int32)
    for t in range(T):
        for s in range(pp):
            g = t - s
            if 0 <= g < M:
                tbl[t, s] = g * W + np.arange(W, dtype=np.int32)
    return tbl


def serving_schedule_stats(tbl):
    """Diagnostics for a `build_serving_tables` table: total ticks,
    per-stage busy fraction, and the bubble fraction the gauges carry.
    A 3-D (tokens-per-tick) table additionally reports the window width
    and `ticks_per_token_max` = T/(M·W), the per-emitted-token tick
    bill at full acceptance — the figure the spec×pp bubble
    amortization divides."""
    if tbl.ndim == 3:
        T, pp, W = tbl.shape
        busy2 = (tbl >= 0).any(-1)
        M = int(busy2[:, 0].sum())
        busy = busy2.sum(0)
        work = int(busy2.sum())
        return {"ticks": int(T),
                "stage_busy": [float(b) / T for b in busy],
                "bubble_frac": float(1.0 - work / (T * pp)),
                "tokens_per_tick": int(W),
                "ticks_per_token_max": float(T) / (M * W)}
    T, pp = tbl.shape
    busy = (tbl >= 0).sum(0)
    work = int((tbl >= 0).sum())
    return {"ticks": int(T),
            "stage_busy": [float(b) / T for b in busy],
            "bubble_frac": float(1.0 - work / (T * pp))}


def schedule_stats(fwd_tbl, bwd_tbl):
    """Diagnostics: total ticks, bubble fraction, peak in-flight per stage."""
    T = fwd_tbl.shape[0]
    pp = fwd_tbl.shape[1]
    work = (fwd_tbl >= 0).reshape(T, -1).sum() + (bwd_tbl >= 0).reshape(T, -1).sum()
    capacity = T * np.prod(fwd_tbl.shape[1:]) * 2
    peak = []
    for s in range(pp):
        f = np.cumsum((fwd_tbl[:, s] >= 0).reshape(T, -1).sum(-1))
        b = np.cumsum((bwd_tbl[:, s] >= 0).reshape(T, -1).sum(-1))
        peak.append(int((f - b).max()))
    return {"ticks": int(T), "bubble_frac": float(1 - work / capacity),
            "peak_inflight": peak}
