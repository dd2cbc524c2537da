"""The port's benchmark: one run of one cell.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program (``fourk_nerf_torch``),
on a machine with the chips the cell asks for. The cell, its
configuration, its traffic mix and its metrics are found by name in
``BENCHMARK.json``; each configuration, mix, metric reader and set of
limits is a file of its own under ``portbench/``. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its limit,
which also end standard error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "fourk_nerf_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is that
    of JAX, its libraries or the JAX package."""
    return sorted({k for k in list(sys.modules)
                   if k.split(".")[0] in FORBIDDEN})


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload named {name!r} in "
                     "BENCHMARK.json")


def metrics_of(bench: dict, name: str, trace: bool) -> list:
    """The cell's metrics: its end-to-end ones, or its per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(name: str):
    path = os.path.join(ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What a cell's driver needs of the run."""

    def __init__(self, workload, cfg, traffic, seed, seconds, trace, device,
                 on_chip, t0=None):
        self.workload, self.cfg, self.traffic = workload, cfg, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.on_chip = device, on_chip
        self.t0 = T0 if t0 is None else t0

    @staticmethod
    def log(msg: str) -> None:
        print(f"portbench: {msg}", flush=True)

    @staticmethod
    def check_modules(when: str) -> None:
        found = forbidden_modules()
        if found:
            raise RuntimeError(f"modules of JAX or the JAX package loaded "
                               f"at {when}: {found}")


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, on_chip: bool, t0=None) -> dict:
    """One run of a cell on ``device``; returns the result line's dict. A
    CPU device (the benchmark's tests) skips the launch-count guard."""
    from portbench import inputs, judge
    cell = cell_of(bench, workload)
    cfg = inputs.config(cell["config"])
    tr = inputs.traffic(cell["traffic"])
    ctx = Context(workload, cfg, tr, seed, seconds, trace, device, on_chip,
                  t0)
    driver = importlib.import_module(f"portbench.drivers.{tr['kind']}")
    rec = driver.run(ctx)
    ctx.log(f"memory peak {rec['memory_peak_bytes']} bytes")
    correct, checks = judge.verdict(rec["numbers"], judge.limits(workload))
    for c in checks.values():  # JSON has no inf or nan
        if not math.isfinite(c["value"]):
            c["value"] = sys.float_info.max
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        v = reader(m["name"])(rec)
        if v is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} has no "
                                   "reading")
            continue
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": rec["attempted"],
              "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if on_chip else device.type,
                         "kind": (_torch().cuda.get_device_name(device)
                                  if on_chip else "cpu"),
                         "count": 1,
                         "memory_peak_bytes": rec["memory_peak_bytes"]}}
    if trace and rec.get("profile"):
        p = rec["profile"]
        result["device"].update(busy_s=p["busy_s"], window_s=p["wall_s"])
        result["breakdown"] = {
            "device_ops": [[n[:160], t] for n, t, _ in p["kernels"][:10]],
            "idle_gaps": [[n[:160], t] for n, t in p["gaps"][:10]]}
    result["checks"] = checks
    return result


def _torch():
    import torch
    return torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest()
    cell = cell_of(bench, args.workload)
    torch = _torch()
    if not torch.cuda.is_available():
        print("portbench: no CUDA device (torch.cuda.is_available() is "
              "False); a measurement never falls back to the CPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} chips, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    # fixed caches inside the checkout: the kernel libraries are built
    # under build/kernels/ by the program; any Triton cache goes beside
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), dev, on_chip=True)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
