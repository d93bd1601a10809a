"""Scheduler decision audit log: `paddle_tpu.decisions.v1`.

Counterpart of `paddle_tpu/observability/decisions.py`, copied, schema
string included, so `tools/serve_report.py` replays the port's records
through the same rules. The serving stack's load-bearing decisions
(admit, shed, preempt, place, swap, quarantine, ...) each leave a typed
record carrying the decision's inputs (queue depth, pool free fraction,
priority, deadline slack, the victim candidates a preemption weighed,
tenant), so the decision is reproducible from its record alone.

Reproducibility is structural: the replay functions here (`replay_shed`,
`replay_victim`, ...) are the same code the scheduler calls to make the
live decision. `validate_records` re-runs the replay over each record's
inputs and flags any record whose stored outcome disagrees.

Record shape (kind "decision", schema `paddle_tpu.decisions.v1`):

  {"kind": "decision", "schema": ..., "action": admit|shed|preempt|
   place|failover|swap|quarantine, "t": float, "emitter": "scheduler"|
   "router", "request_id"/"key": ..., "tenant": str, "cohort": str?,
   "trace_id": str?, "inputs": {...}, "outcome": {...}}

The router's rules (place, failover, health, retry budget, migrate) are
the ones `serving/distributed/router.py` records under, so one validator
grades both emitters. Stdlib-only.
"""

__all__ = ["SCHEMA", "ACTIONS", "DEFAULT_TENANT", "build_record",
           "replay_shed", "replay_victim", "replay_place",
           "replay_affinity_place", "replay_rate_limit", "replay_health",
           "replay_retry_budget", "replay_migrate",
           "validate_records", "by_tenant"]

SCHEMA = "paddle_tpu.decisions.v1"

ACTIONS = ("admit", "shed", "preempt", "place", "failover", "swap",
           "quarantine", "rate_limit", "health", "migrate", "drain",
           "retry_budget")

# the tenant label value of unlabeled traffic: one vocabulary across
# the scheduler, router, metrics labelsets, and reports, so single-
# tenant artifacts grade identically before and after the label landed
DEFAULT_TENANT = "default"


def build_record(action, inputs, outcome, emitter, t, request_id=None,
                 key=None, tenant=None, cohort=None, trace_id=None):
    """One decisions.v1 record. `inputs` must hold everything the
    matching replay function needs; `outcome` what was decided."""
    if action not in ACTIONS:
        raise ValueError(f"unknown decision action {action!r}; "
                         f"want one of {ACTIONS}")
    rec = {"kind": "decision", "schema": SCHEMA, "action": str(action),
           "t": float(t), "emitter": str(emitter),
           "tenant": str(tenant) if tenant is not None else DEFAULT_TENANT,
           "inputs": dict(inputs), "outcome": dict(outcome)}
    if request_id is not None:
        rec["request_id"] = int(request_id)
    if key is not None:
        rec["key"] = str(key)
    if cohort is not None:
        rec["cohort"] = str(cohort)
    if trace_id is not None:
        rec["trace_id"] = str(trace_id)
    return rec


# ------------------------------------------------------------- the replays
#
# These ARE the live decision rules — the scheduler/router call them with
# the same inputs dict they record, so a record's outcome can never
# disagree with its replay except through a code change (which the
# validator then flags on historical artifacts, loudly and on purpose).

def replay_shed(inputs):
    """The admission load-shed rule over recorded inputs. Returns the
    binding reason string, or None to admit.

    inputs: priority, shed_priority, queue_depth, shed_watermark (or
    None), pool_free_fraction (or None), shed_pool_free (or None)."""
    prio = int(inputs["priority"])
    if prio < int(inputs["shed_priority"]):
        return None
    wm = inputs.get("shed_watermark")
    if wm is not None and int(inputs["queue_depth"]) >= int(wm):
        return (f"queue depth {inputs['queue_depth']} >= watermark "
                f"{int(wm)}")
    floor = inputs.get("shed_pool_free")
    free = inputs.get("pool_free_fraction")
    if floor is not None and free is not None and \
            float(free) < float(floor):
        return (f"block pool free fraction {float(free):.3f} < "
                f"{float(floor)}")
    return None


def replay_rate_limit(inputs):
    """The token-budget admission rule over recorded inputs:
    a request costing more tokens than its tenant's bucket holds is
    limited. Returns the binding reason string, or None to admit.

    inputs: tenant, cost (prompt + max_new tokens), tokens_available
    (the bucket's post-refill level at decision time), rate_per_s,
    burst. A request whose cost exceeds `burst` can NEVER admit — the
    reason says so explicitly so operators see the misconfiguration."""
    cost = float(inputs["cost"])
    avail = float(inputs["tokens_available"])
    if cost <= avail:
        return None
    burst = inputs.get("burst")
    if burst is not None and cost > float(burst):
        return (f"cost {cost:g} exceeds bucket capacity "
                f"{float(burst):g} (never admissible)")
    return (f"cost {cost:g} > tokens available {avail:g}")


def replay_victim(candidates, worse_than=None):
    """The preemption-victim rule over a recorded candidate table:
    worst priority class first, most deadline slack within a class
    (slack None == infinite — batch work yields before anything on a
    clock); earliest-listed candidate wins ties, matching the
    scheduler's slot-order scan. Returns the winning candidate dict, or
    None.

    candidates: [{"slot", "request_id", "tenant", "priority",
    "deadline_slack_s" (None == no deadline)}, ...] in slot order."""
    best, best_key = None, None
    for cand in candidates:
        prio = int(cand["priority"])
        if worse_than is not None and prio <= int(worse_than):
            continue
        slack = cand.get("deadline_slack_s")
        slack = float("inf") if slack is None else float(slack)
        key = (prio, slack)
        if best is None or key > best_key:
            best, best_key = cand, key
    return best


def replay_place(inputs):
    """The router placement rule over recorded inputs: the live worker
    carrying the fewest in-flight requests, lowest index on ties.

    inputs: {"loads": {worker_id(str|int): inflight_count}}."""
    loads = inputs["loads"]
    if not loads:
        return None
    return min(sorted(loads, key=lambda k: int(k)),
               key=lambda k: loads[k])


def replay_affinity_place(inputs):
    """The prefix-affinity router placement rule over
    recorded inputs: longest-prefix-match wins AHEAD of least-loaded —
    recomputing a long cached prefix costs more than a small load skew —
    unless the owner is already `load_slack` requests busier than the
    least-loaded worker, in which case placement falls back to the plain
    least-loaded rule (`replay_place`). Lowest worker index wins match
    ties, mirroring the load-tie rule.

    inputs: {"loads": {worker_id: inflight_count},
             "matches": {worker_id: matched_prefix_tokens},
             "min_match": int (tokens; matches below it don't bind),
             "load_slack": number}."""
    loads = inputs["loads"]
    if not loads:
        return None
    matches = inputs.get("matches") or {}
    min_match = int(inputs.get("min_match", 1))
    slack = float(inputs.get("load_slack", 0))
    best, best_tok = None, 0
    for w in sorted(loads, key=lambda k: int(k)):
        tok = int(matches.get(w) or matches.get(str(w)) or 0)
        if tok >= min_match and tok > best_tok:
            best, best_tok = w, tok
    if best is not None and float(loads[best]) - \
            min(float(v) for v in loads.values()) <= slack:
        return best
    return replay_place(inputs)


def replay_health(inputs):
    """The gray-failure health-state rule over recorded
    inputs: a worker's suspicion score against the router's two
    thresholds. Returns "healthy" | "suspect" | "dark".

    inputs: {"suspicion": float, "suspect_threshold": float,
             "dark_threshold": float}. The suspicion score itself is
    continuous telemetry (phi-accrual staleness + latency ratios vs the
    fleet); only the thresholded STATE is a decision, so only the
    thresholding is replayed."""
    s = float(inputs["suspicion"])
    if s >= float(inputs["dark_threshold"]):
        return "dark"
    if s >= float(inputs["suspect_threshold"]):
        return "suspect"
    return "healthy"


def replay_retry_budget(inputs):
    """The per-worker retry token-bucket rule over recorded
    inputs — the retry-storm brake. Returns the binding reason string
    (the retry is DENIED), or None when the budget covers it.

    inputs: {"worker": id, "cost": tokens, "tokens_available": the
    bucket's post-refill level at decision time}. Mirrors
    `replay_rate_limit`: denial records replay to a reason, grants are
    not recorded (they are the common case and carry no information
    beyond the counters)."""
    cost = float(inputs.get("cost", 1.0))
    avail = float(inputs["tokens_available"])
    if cost <= avail:
        return None
    return (f"worker {inputs.get('worker')} retry budget exhausted: "
            f"cost {cost:g} > tokens available {avail:g}")


def replay_migrate(inputs):
    """The proactive-migration rule over recorded inputs:
    move a stream off a worker the moment the worker leaves `healthy`,
    provided the stream still has tokens to produce and somewhere
    healthy to go. Returns True to migrate.

    inputs: {"state": the source worker's health state ("suspect" |
    "dark" | "drain"), "tokens_remaining": tokens the stream still
    owes, "eligible_workers": [healthy target ids]}."""
    if inputs.get("state") not in ("suspect", "dark", "drain"):
        return False
    if int(inputs.get("tokens_remaining", 0)) < 1:
        return False
    return len(inputs.get("eligible_workers") or ()) > 0


# ------------------------------------------------------------- validation

def _replay_errors(rec):
    """Re-run the replay rule over the record's inputs; return mismatch
    descriptions ([] when the outcome reproduces or no rule applies)."""
    action = rec.get("action")
    inputs = rec.get("inputs") or {}
    outcome = rec.get("outcome") or {}
    try:
        if action == "shed":
            why = replay_shed(inputs)
            if why is None:
                return ["shed record's inputs do not shed on replay"]
            if outcome.get("reason") != why:
                return [f"shed reason {outcome.get('reason')!r} != "
                        f"replayed {why!r}"]
        elif action == "rate_limit":
            why = replay_rate_limit(inputs)
            if why is None:
                return ["rate_limit record's inputs admit on replay"]
            if outcome.get("reason") != why:
                return [f"rate_limit reason {outcome.get('reason')!r} "
                        f"!= replayed {why!r}"]
        elif action == "preempt":
            got = replay_victim(inputs.get("candidates") or (),
                                worse_than=inputs.get("worse_than"))
            want_slot = outcome.get("victim_slot")
            if got is None:
                return ["preempt record has no eligible victim on replay"]
            if int(got["slot"]) != int(want_slot):
                return [f"preempt victim slot {want_slot} != replayed "
                        f"slot {got['slot']}"]
        elif action == "health":
            got = replay_health(inputs)
            want = outcome.get("state")
            if want is not None and got != want:
                return [f"health state {want!r} != replayed {got!r}"]
        elif action == "retry_budget":
            why = replay_retry_budget(inputs)
            if why is None:
                return ["retry_budget record's inputs grant on replay"]
            if outcome.get("reason") != why:
                return [f"retry_budget reason {outcome.get('reason')!r} "
                        f"!= replayed {why!r}"]
        elif action == "migrate":
            got = replay_migrate(inputs)
            want = outcome.get("migrated")
            if want is not None and bool(got) != bool(want):
                return [f"migrate outcome {want!r} != replayed {got!r}"]
        elif action == "place" and "matches" in inputs:
            got = replay_affinity_place(inputs)
            want = outcome.get("worker")
            if want is not None and got is not None and \
                    str(got) != str(want):
                return [f"affinity place worker {want!r} != replayed "
                        f"{got!r}"]
        elif action == "place" and "loads" in inputs:
            got = replay_place(inputs)
            want = outcome.get("worker")
            if want is not None and got is not None and \
                    str(got) != str(want):
                return [f"place worker {want!r} != replayed {got!r}"]
    except (KeyError, TypeError, ValueError) as e:
        return [f"replay failed: {type(e).__name__}: {e}"]
    return []


def validate_records(records):
    """Schema + reproducibility violations over decision records
    ([] == every decision valid AND reproducible from its inputs)."""
    errors = []
    for i, rec in enumerate(records):
        if rec.get("kind") != "decision":
            errors.append(f"record {i}: kind={rec.get('kind')!r}, "
                          f"want 'decision'")
            continue
        where = f"record {i} (decision/{rec.get('action')})"
        if rec.get("schema") != SCHEMA:
            errors.append(f"{where}: schema={rec.get('schema')!r}, "
                          f"want {SCHEMA!r}")
        if rec.get("action") not in ACTIONS:
            errors.append(f"{where}: unknown action {rec.get('action')!r}")
        if not isinstance(rec.get("t"), (int, float)):
            errors.append(f"{where}: t={rec.get('t')!r} invalid")
        if not isinstance(rec.get("tenant"), str) or not rec["tenant"]:
            errors.append(f"{where}: tenant={rec.get('tenant')!r} invalid")
        if rec.get("emitter") not in ("scheduler", "router"):
            errors.append(f"{where}: emitter={rec.get('emitter')!r} "
                          f"invalid")
        for fld in ("inputs", "outcome"):
            if not isinstance(rec.get(fld), dict):
                errors.append(f"{where}: {fld} missing or not a dict")
        if isinstance(rec.get("inputs"), dict) and \
                isinstance(rec.get("outcome"), dict):
            errors.extend(f"{where}: {e}" for e in _replay_errors(rec))
    return errors


def by_tenant(records):
    """{tenant: {action: count}} over decision records — the
    serve_report per-tenant decision table's data."""
    out = {}
    for rec in records:
        if rec.get("kind") != "decision":
            continue
        t = rec.get("tenant") or DEFAULT_TENANT
        out.setdefault(t, {})
        out[t][rec["action"]] = out[t].get(rec["action"], 0) + 1
    return out
