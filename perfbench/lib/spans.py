"""Where a traced window's device time and idle time go, by the program's
own regions: the ``repro_torch.*`` ranges that ``repro_torch.obs.trace.
region`` opens while ``torch.profiler`` records (the train step, its
forward and backward, the attention backward, the optimizer update, the
gradient sync, each collective and phase).

* **Device operations.**  Each kernel, copy or fill in the window
  belongs to the innermost program range open when the host launched
  it: the operation's CUPTI correlation id leads to its launch (the CUDA
  runtime or driver call with the same id), which is exact on any
  stream; without such a call in the trace, the host operation Kineto
  linked it to stands in.  Ranges nest by time, across threads: the
  autograd engine's
  device thread runs the backward while the caller waits inside
  ``repro_torch.train.backward``.  An operation launched outside every
  range is the harness's (``(harness)``); one whose launch is not in the
  trace is ``(no launch)``.
* **Idle gaps.**  Every gap between device operations is charged to the
  innermost range of the operation that ends it, the range whose late
  launch left the card idle; a gap that ends at a harness operation or
  at the window's end is the harness's.

:func:`table` keys what it finds by the range's path (the names from
the outermost range down, joined by ``" > "``), so an operation counts
under one innermost range only, and a range's total is the sum over the
paths through it.  A step is a ``repro_torch.train.step`` call in the
window.

Until ``profile.py`` keeps these ranges in its ``Trace``, run a cell
with the table beside its result line:

    python3 -m perfbench.lib.spans --workload minicpm-2b.train-4k \\
        --seed 5 --seconds 40
"""

from __future__ import annotations

import dataclasses
import json
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from perfbench.lib import profile

PREFIX = "repro_torch."
STEP = "repro_torch.train.step"
SEP = " > "
HARNESS = "(harness)"
NO_LAUNCH = "(no launch)"
#: host-side names of the CUDA calls that launch device work
_LAUNCH_PREFIXES = ("cuda", "cu")


@dataclasses.dataclass
class Spans:
    window: Tuple[int, int]
    ranges: List[Tuple[int, int, str]]    # program ranges, by start
    ops: List[Tuple[int, int, int]]       # (start, end, launch ns or -1)


def collect(events) -> Spans:
    """The window, the program's ranges and the device operations with
    their launch times, from the profiler's raw events (``_KinetoEvent``;
    the device operations are those ``profile.reduce_events`` counts)."""
    from torch.autograd import DeviceType
    window, ranges, launches, ops, host = None, [], {}, [], []
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation() and \
                    not name.startswith("perfbench."):
                ops.append((s, e, ev.correlation_id(),
                            ev.linked_correlation_id()))
            continue
        if name == profile.WINDOW:
            window = (s, e)
        elif name.startswith(PREFIX):
            ranges.append((s, e, name))
        if name.startswith(_LAUNCH_PREFIXES) and \
                not ev.is_user_annotation():
            launches[ev.correlation_id()] = s
        else:
            host.append(ev)
    if window is None:
        raise RuntimeError(f"the trace has no {profile.WINDOW} range")
    w0, w1 = window
    ops = [o for o in ops if o[1] > w0 and o[0] < w1]
    linked = {o[3] for o in ops if o[2] not in launches and o[3] > 0}
    started = {ev.correlation_id(): ev.start_ns() for ev in host
               if ev.correlation_id() in linked}
    ops = sorted((max(s, w0), min(e, w1),
                  launches.get(c, started.get(k, -1)))
                 for s, e, c, k in ops)
    ranges.sort(key=lambda r: (r[0], -r[1]))
    return Spans(window, ranges, ops)


def _paths(ranges: List[Tuple[int, int, str]]) -> List[str]:
    """Each range's path: the names of the ranges that hold it (by time)
    and its own."""
    out, stack = [], []
    for s, e, name in ranges:
        while stack and stack[-1][0] <= s:
            stack.pop()
        path = (stack[-1][1] + SEP + name) if stack else name
        out.append(path)
        stack.append((e, path))
    return out


def _innermost(ranges, paths, times: List[int]) -> List[str]:
    """The path of the innermost range holding each of ``times`` (sorted
    ascending; -1 for an unknown time)."""
    out, stack, i = [], [], 0
    for t in times:
        if t < 0:
            out.append(NO_LAUNCH)
            continue
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and ranges[stack[-1]][1] <= ranges[i][0]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and ranges[stack[-1]][1] < t:
            stack.pop()
        out.append(paths[stack[-1]] if stack else HARNESS)
    return out


def table(sp: Spans) -> Dict[str, Dict[str, float]]:
    """``{path: {"device_s", "launches", "calls", "idle_s"}}``: the busy
    seconds (the union of the operations' intervals) and the number of
    the operations whose innermost range is ``path``, its calls that
    start in the window, and the idle seconds charged to it."""
    paths = _paths(sp.ranges)
    w0, w1 = sp.window
    by_launch = sorted(range(len(sp.ops)), key=lambda j: sp.ops[j][2])
    where = [""] * len(sp.ops)
    for j, path in zip(by_launch, _innermost(
            sp.ranges, paths, [sp.ops[j][2] for j in by_launch])):
        where[j] = path
    out: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"device_s": 0.0, "launches": 0, "calls": 0,
                 "idle_s": 0.0})
    for (s, _, _), path in zip(sp.ranges, paths):
        if w0 <= s < w1:
            out[path]["calls"] += 1
    ends: Dict[str, int] = {}
    cur = w0
    for (s, e, _), path in zip(sp.ops, where):
        row = out[path]
        row["launches"] += 1
        last = max(ends.get(path, s), s)
        if e > last:
            row["device_s"] += (e - last) * 1e-9
            ends[path] = e
        if s > cur:
            row["idle_s"] += (s - cur) * 1e-9
        cur = max(cur, e)
    if w1 > cur:
        out[HARNESS]["idle_s"] += (w1 - cur) * 1e-9
    return dict(out)


def _under(path: str, name: str) -> bool:
    return name in path.split(SEP)


def steps(tab: Dict[str, dict]) -> int:
    return sum(row["calls"] for path, row in tab.items()
               if path.split(SEP)[-1] == STEP)


def per_step_ms(tab: Dict[str, dict], name: str, key: str = "device_s"
                ) -> Optional[float]:
    """Milliseconds a step of ``key`` over the paths through ``name``;
    None without steps or without such a range."""
    n = steps(tab)
    rows = [row for path, row in tab.items() if _under(path, name)]
    if not n or not rows:
        return None
    return 1e3 * sum(row[key] for row in rows) / n


def readings(tab: Dict[str, dict]) -> Dict[str, Optional[float]]:
    """The per-layer readings the ranges give: the attention backward's
    and the optimizer update's device ms a step, and the idle ms a step
    charged inside the train step."""
    return {"attn_bwd_ms.train": per_step_ms(tab,
                                             "repro_torch.attn.backward"),
            "optimizer_ms.train": per_step_ms(tab,
                                              "repro_torch.optim.update"),
            "step_idle_ms.train": per_step_ms(tab, STEP, "idle_s")}


def cover(tab: Dict[str, dict], name: str = STEP) -> Tuple[float, float]:
    """(device seconds, idle seconds) of the paths through ``name``."""
    rows = [row for path, row in tab.items() if _under(path, name)]
    return (sum(r["device_s"] for r in rows),
            sum(r["idle_s"] for r in rows))


def main(argv=None) -> int:
    """One traced run of a cell, as ``perfbench/run.py --trace 1`` runs
    it, with the program's ranges reduced beside the trace: one JSON
    line of the readings, the steps, the busy share inside the step, the
    table, and ``run.py``'s own result line."""
    import argparse
    ap = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from perfbench import run
    from perfbench.lib import checks, env, manifest
    env.setup_environment()
    cell = manifest.load_cell(args.workload)
    found = {}
    reduce_events = profile.reduce_events

    def both(events):
        events = list(events)
        found["spans"] = collect(events)
        return reduce_events(events)

    profile.reduce_events = both
    try:
        res = run.run_cell(cell, args.seed, args.seconds, True)
    finally:
        profile.reduce_events = reduce_events
    tab = table(found["spans"])
    busy = res["trace"]["busy_s"]
    inside, _ = cover(tab)
    result, _ = run.result_line(cell, res, True, "cuda",
                                checks.limits(cell.name))
    line = {"readings": readings(tab), "steps": steps(tab),
            "busy_inside_step": inside / busy if busy else None,
            "table": {p: tab[p] for p in sorted(
                tab, key=lambda p: -tab[p]["device_s"] - tab[p]["idle_s"])},
            "result": result}
    print(f"perfbench: {run.summary(res)}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
