"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``vectorchord_bm25_tpu_torch``.
The last line on standard output is one JSON object; the last lines on
standard error are the numbers the comparison read, each beside its
limit.  Exits non-zero, with no result, when torch sees no card or fewer
cards than the cell asks for, when the port is not in the checkout, or
when the process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vectorchord_bm25_tpu", "bench")
PORT = "vectorchord_bm25_tpu_torch"


def forbidden_modules(names=None) -> list:
    """Top-level names of loaded modules (``sys.modules`` by default) that
    the benchmark may not load, compared whole: ``vectorchord_bm25_tpu_torch``
    is not the JAX package."""
    tops = {name.split(".", 1)[0] for name in (list(sys.modules) if names is None else names)}
    return sorted(tops.intersection(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    root = os.getcwd()
    # Every build and kernel cache stays in the checkout, at fixed paths.
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, ".portbench_cache", "triton")
    from . import harness, manifest

    bench = manifest.load_benchmark(root)
    cell = manifest.load_cell(bench, args.workload)
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    spec = importlib.util.find_spec(PORT)
    if spec is None or not os.path.abspath(spec.origin).startswith(root + os.sep):
        print(f"portbench: {PORT} is not in this checkout ({root})", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(
            f"portbench: {args.workload} needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
            file=sys.stderr,
        )
        return 2
    result, lines = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    card = power_limit()
    result["card"] = card
    result["checks"] = result.pop("checks")
    for line in lines:
        print(f"portbench: {line}", file=sys.stderr)
    print(f"portbench: card {card}; correct {result['correct']}", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"{name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
