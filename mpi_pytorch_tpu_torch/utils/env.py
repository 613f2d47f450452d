"""``MPT_*`` env-knob parsing (the JAX package's ``utils/env.py``): one
definition of truthiness — the same falsy set as the JAX package's:
case-insensitive '', '0', 'false', 'no' and 'off' mean off, anything else
means on — integer knobs, and the registry of the fault-injection gates
the trainer honors.

Fault gates (``MPT_FAULT_*``) are the deterministic chaos levers of the
elastic-resume tests: every gate the port honors is registered here
(name → meaning), with the JAX package's names and texts, and the
accessors refuse an unregistered name, so a typo'd gate fails loudly
instead of silently never firing."""

from __future__ import annotations

import os
import threading

FALSY = ("", "0", "false", "no", "off")


def env_flag(name: str, default: bool = False) -> bool:
    """The value of boolean env knob ``name``; ``default`` when unset."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.lower() not in FALSY


def env_int(name: str, default: int = 0) -> int:
    """The value of integer env knob ``name``; ``default`` when unset or
    empty. Raises on a non-integer value (a malformed gate must fail
    loudly, not silently disable the fault it was meant to inject)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    return int(raw)


# The gates the port's trainer fires (train/elastic.py FaultInjector and
# PreemptionWatchdog, parallel/mesh.create_mesh, the resume placement).
FAULT_GATES: dict[str, str] = {
    "MPT_FAULT_KILL_AT_STEP": (
        "SIGKILL this process immediately after the Nth completed train "
        "step (1-based, counted across epochs) — a deterministic mid-run "
        "crash with an async checkpoint possibly in flight"
    ),
    "MPT_FAULT_DELAY_STEP_MS": (
        "sleep this many ms inside every timed train step — fakes a "
        "straggler host for the heartbeat/watchdog path. On a serve FLEET "
        "host (serve/fleet/) the same gate delays every dispatched flush "
        "instead, faking a slow serving host for the router's load-aware "
        "dispatch"
    ),
    "MPT_FAULT_DELAY_PROCESS": (
        "restrict MPT_FAULT_DELAY_STEP_MS to this process index — or, on "
        "an in-process serve fleet, to this fleet-host index "
        "(unset/-1 = every process/host)"
    ),
    "MPT_FAULT_DELAY_AFTER_STEP": (
        "start MPT_FAULT_DELAY_STEP_MS only after this many steps have run "
        "cleanly (0 = from the first step) — a straggler that APPEARS "
        "mid-run, so warmup-baseline SLO rules (drift:) have a clean "
        "baseline to drift from"
    ),
    "MPT_FAULT_DCN_DELAY_MS": (
        "fake a slow DCN link: add this many ms to every train step's "
        "CROSS-POD phase — the gate bites ONLY on hierarchical "
        "(--mesh-pods > 1) runs, because only those have a DCN phase to "
        "slow down; a flat-mesh run under the same gate is unaffected, "
        "which is exactly the testable overlap contract (host-side "
        "stand-in applied inside the timed step region, so heartbeats and "
        "step records attribute the latency to the step it stretched)"
    ),
    "MPT_FAULT_BACKEND_WEDGE_N": (
        "make the first N create_mesh calls in this process raise — the "
        "wedged-backend-init scenario the resume-side retry loop absorbs"
    ),
    "MPT_FAULT_DEVICE_PUT_N": (
        "make the first N resume-side state placements raise — exercises "
        "the bounded retry+backoff around device_put on restore"
    ),
    "MPT_FAULT_NONFINITE_AT_STEP": (
        "poison the Nth train batch (1-based, counted across epochs) with "
        "NaN pixels so that step's loss/grad norm go non-finite — announced "
        "with a kind='fault' record BEFORE the step runs, so the bad-step "
        "policies (--bad-step-policy skip|rollback) are testable without a "
        "hand-tuned poisoned learning rate. Streaming float-input train "
        "path only (uint8 batches cannot carry a NaN; the device-cache "
        "path feeds indices, not pixels)"
    ),
    "MPT_FAULT_PREEMPT_AT_STEP": (
        "behave as if a preemption notice arrived right after the Nth "
        "completed train step (1-based, counted across epochs) — a "
        "deterministic mid-epoch stop that exercises the dirty-save + "
        "exact-step-resume path without racing a real signal"
    ),
    "MPT_PREEMPT_FILE": (
        "path to a preemption sentinel: when the file exists, the trainer's "
        "watchdog stops at the next safe boundary, saves, and exits 0 "
        "(the cluster-scheduler preemption-notice pattern)"
    ),
}

# In-process countdown state of the *_N gates: each counts down from its
# env value as its fault site fires, so "wedge for N attempts" is exact
# within one process. Lock-guarded: a check-then-decrement on concurrent
# threads would let an N-shot gate fire more than N times.
_fault_counters: dict[str, int] = {}
_fault_lock = threading.Lock()


def reset_fault_counters() -> None:
    """Forget consumed countdowns (tests; a fresh process needs nothing)."""
    with _fault_lock:
        _fault_counters.clear()


def fault_countdown(name: str) -> bool:
    """True while gate ``name`` still has shots left (and consume one).
    Unset or zero gates never fire. ``name`` must be a registered
    :data:`FAULT_GATES` entry; anything else raises."""
    if name not in FAULT_GATES:
        raise KeyError(f"unregistered fault gate {name!r} (see utils/env.py FAULT_GATES)")
    with _fault_lock:
        if name not in _fault_counters:
            _fault_counters[name] = env_int(name, 0)
        if _fault_counters[name] <= 0:
            return False
        _fault_counters[name] -= 1
        return True
