"""Run one cell of the benchmark once:

    python3 streambench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``selkies_tpu_torch``).
Prints one JSON object as the last line of standard output and, as the
last lines of standard error, each number the comparison checked beside
its limit. Exits with another code than 0, and prints no result, without
enough CUDA cards, when the port or the reference fails, when a thread of
the program outlives the run, or when a forbidden module was loaded.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    whatever the environment named."""
    cache = ROOT / ".streambench-cache"
    os.environ["SELKIES_TORCH_KERNEL_DIR"] = str(ROOT / "build"
                                                 / "torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        print("--seed must be >= 0", file=sys.stderr)
        return 2
    _caches()
    sys.path.insert(0, str(ROOT))

    from streambench import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    res = harness.resolve(args.workload, spec)

    import torch

    chips = int(res["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 3
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), T_PROCESS, spec=spec)
    except harness.RunError as e:
        print(f"run failed: {e}", file=sys.stderr)
        return 4
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 5
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
