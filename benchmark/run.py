"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root. A run is set-up (imports, the card, the scene,
the program's tree, warm-up of the cell's own shapes), a window of
``--seconds`` of closed-loop requests, with ``--trace 1`` a profiled stretch
of whole requests after it, the check of what the window produced against
the plain reference, and one JSON line on standard output. Everything that
belongs to a cell is found by name: ``BENCHMARK.json`` names the cell's
configuration and metrics, ``workloads/<cell>.json`` its driver and traffic,
``configs/``, ``drivers/<driver>.py`` and ``metrics/<metric>.py`` the rest.

A run that finds no card, or fewer than the cell asks for, exits 2 and
prints no result; so does one that finds JAX or the JAX package loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Whole top-level module names that no run may hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "minipath_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_module(path: Path):
    """A module from a file under the benchmark, found by its name."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Context:
    """What a metric reader may read."""

    bench: dict  # BENCHMARK.json
    workload: dict  # the cell's entry there
    params: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    device: object
    setup_s: float
    records: list = field(default_factory=list)  # one dict a request of the window
    window_start: float = 0.0
    window_end: float = 0.0  # when the last request of the window ended
    state: object = None  # the driver's state
    trace: object = None  # profile.Trace of the profiled stretch (``--trace 1``)
    traced: list = field(default_factory=list)  # the profiled stretch's requests
    cache: dict = field(default_factory=dict)  # shared between readers


def metric_names(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones."""
    if not trace:
        return [m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    reported = set(metric_names(bench, cell, False))
    return [m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]


def run(workload: str, seed: int, seconds: float, trace: bool, device=None, bench_path: Path | None = None,
        out=sys.stdout, err=sys.stderr) -> int:
    """One run of ``workload``. ``device`` None takes the first card and
    fails without one; tests pass another to drive the rest of a run."""
    import torch

    from benchmark.harness import device as card
    from benchmark.harness import profile

    t_import = time.perf_counter() - T0
    bench = load_json(bench_path or ROOT / "BENCHMARK.json")
    base = (bench_path or ROOT / "BENCHMARK.json").resolve().parent
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        print(f"no workload {workload!r} in BENCHMARK.json", file=err)
        return 2
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    if device is None:
        try:
            device = card.require(cell["chips"])
        except card.NoCard as e:
            print(f"no result: {e}", file=err)
            return 2
    bench_dir = base / bench["paths"][0]
    params = load_json(bench_dir / "workloads" / f"{workload}.json")
    config = load_json(base / cfg_entry["file"])
    driver = load_module(bench_dir / "drivers" / f"{params['driver']}.py")

    t_context = time.perf_counter()
    if device.type == "cuda":
        torch.zeros(1, device=device)  # the CUDA context
    t_context = time.perf_counter() - t_context
    state = driver.setup(config, params, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ctx = Context(bench, cell, params, config, device, time.perf_counter() - T0, state=state)
    steps = {"imports": t_import, "context": t_context, **getattr(getattr(state, "phases", None), "spans", {})}
    print(f"setup_s {ctx.setup_s:.3f}: " + ", ".join(f"{k} {v:.3f}" for k, v in steps.items()), file=err)

    ctx.window_start = time.perf_counter()
    while time.perf_counter() - ctx.window_start < seconds:
        ctx.records.append(driver.request(state))
    ctx.window_end = ctx.records[-1]["end"]
    took = [r["end"] - r["start"] for r in ctx.records]
    print(f"window: {len(took)} requests, the first {took[0]:.4f} s, the median {sorted(took)[len(took) // 2]:.4f} s,"
          f" the slowest {max(took):.4f} s", file=err)

    if trace:
        with profile.profiled(bench_dir / ".cache" / "traces" / f"{workload}.json") as got:
            with torch.profiler.record_function(profile.WINDOW):
                for _ in range(params["trace_requests"]):
                    ctx.traced.append(driver.request(state))
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        ctx.trace = got[0]

    dev_info = card.describe(device, cell["chips"])
    metrics = {}
    for name in metric_names(bench, workload, trace):
        spec = next(m for m in bench["end_to_end"] + bench["per_layer"] if m["name"] == name)
        value = load_module(bench_dir / "metrics" / f"{name}.py").read(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": spec["unit"]}

    t_check = time.perf_counter()
    checks = driver.check(state, ctx.records, seed)
    print(f"the check took {time.perf_counter() - t_check:.3f} s", file=err)
    correct = all(value <= limit for value, limit in checks.values())
    result = {"correct": correct, "attempted": len(ctx.records), "failed": 0, "metrics": metrics, "device": dev_info}
    if trace:
        result["device"]["busy_s"] = ctx.trace.busy_s()
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = profile.breakdown(ctx.trace)
    found = forbidden_modules()
    if found:
        print(f"no result: the run loaded {', '.join(found)}", file=err)
        return 2
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    for name, (v, lim) in checks.items():
        print(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=err)
    print(json.dumps(result), file=out)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    return run(a.workload, a.seed, a.seconds, bool(a.trace))


if __name__ == "__main__":
    sys.exit(main())
