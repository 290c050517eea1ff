"""Device profiling hooks (SURVEY.md §5.1): thin wrappers over
jax.profiler so a pipeline run can emit a trace, named scopes so kernel
launches are attributable in it, and the reduction of a trace to device
seconds per jitted program."""

from __future__ import annotations

import collections
import contextlib
import glob
import os
from typing import Dict, Iterator


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[str]:
    """Capture a profiler trace around a block; yields the log dir. A
    profiler that cannot start raises: a run that asked for a trace
    never silently goes without one."""
    import jax

    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def device_seconds_by_module(log_dir: str) -> Dict[str, float]:
    """Device time per XLA module (one jitted function is one module,
    named ``jit_<function>``) in the newest trace under `log_dir`: the
    summed durations of the events that device planes attribute to it
    through their ``hlo_module`` stat. Device events with no module,
    such as copies, are summed under ``[<event name>]``."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(
        log_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb trace under {log_dir}")
    totals: Dict[str, float] = collections.defaultdict(float)
    for plane in ProfileData.from_file(paths[-1]).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                module = dict(ev.stats).get("hlo_module")
                key = module if module is not None else f"[{ev.name}]"
                totals[key] += ev.duration_ns * 1e-9
    return dict(totals)


def named(name: str):
    """Named scope for trace attribution: with named('stage1'): ..."""
    import jax

    return jax.profiler.TraceAnnotation(name)
