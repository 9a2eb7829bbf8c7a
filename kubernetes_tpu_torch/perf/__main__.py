"""The scheduler_perf matrix: ``python -m kubernetes_tpu_torch.perf`` (an own
copy of ``kubernetes_tpu/perf/__main__.py``).

Runs every ``TEST_CASES`` workload (scheduler_perf's BenchmarkPerfScheduling
matrix, test/integration/scheduler_perf/scheduler_perf_test.go:554), or the
``--cases`` subset, against one backend and writes one DataItems JSON file
per case, the dataItems2JSONFile layout (util.go:165), plus
``summary.json``:

    python -m kubernetes_tpu_torch.perf --backend tpu --out perf_artifacts \\
        --scale 0.2 --cases SchedulingBasic,TopologySpreading

``--scale`` shrinks every integer size parameter (nodes, pods; at least 8)
for smoke runs; 1.0 is the reference size. The batched backends run on the
CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import time


def _scaled_case(factory, scale: float) -> dict:
    """Build a test case with every integer size parameter scaled."""
    sig = inspect.signature(factory)
    kwargs = {}
    for name, param in sig.parameters.items():
        if isinstance(param.default, int) and not isinstance(param.default, bool):
            kwargs[name] = max(8, int(param.default * scale))
    return factory(**kwargs)


def main(argv=None) -> int:
    from .cases import TEST_CASES
    from .harness import data_items_to_json, run_workload

    ap = argparse.ArgumentParser(prog="kubernetes_tpu_torch.perf")
    ap.add_argument("--backend", default="tpu",
                    choices=["oracle", "tpu", "wire", "grpc"])
    ap.add_argument("--out", default="perf_artifacts")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--cases", default="",
                    help="comma-separated subset (default: all)")
    ap.add_argument("--device", default=None,
                    help="torch device of the batched backends (default: the CUDA card)")
    args = ap.parse_args(argv)

    wanted = [c for c in args.cases.split(",") if c] or list(TEST_CASES)
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for name in wanted:
        factory = TEST_CASES.get(name)
        if factory is None:
            print(f"unknown case {name!r}; have {sorted(TEST_CASES)}",
                  file=sys.stderr)
            failures += 1
            continue
        case = _scaled_case(factory, args.scale)
        t0 = time.perf_counter()
        try:
            items = run_workload(case, backend=args.backend, device=args.device)
        except Exception as exc:  # noqa: BLE001 - one bad case must not kill the matrix
            print(f"{name}: FAILED {type(exc).__name__}: {exc}", file=sys.stderr)
            failures += 1
            continue
        path = os.path.join(args.out, f"{name}.json")
        with open(path, "w") as f:
            f.write(data_items_to_json(items))
        tput = next((it.data.get("Average") for it in items
                     if it.labels.get("Name") == "SchedulingThroughput"), None)
        dur = time.perf_counter() - t0
        print(f"{name}: {tput and round(tput, 1)} pods/s "
              f"({dur:.1f}s) -> {path}")
    summary = {
        "backend": args.backend, "scale": args.scale,
        "cases": len(wanted), "failures": failures,
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
