"""The benchmark's command:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the card(s) the cell
asks for. It prints one JSON line last on standard output (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
then `checks`), each compared number with its limit last on standard
error, and exits non-zero without a result where there is no card, where
the cell is unknown, or where JAX or the JAX package got loaded. Build and
kernel caches stay inside the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(_ROOT, ".bench_cache", _sub)


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("benchmark.run")
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1),
                    help="1: report the per-layer metrics, from a traced window after it")
    ap.add_argument("--trace_dir", default=None,
                    help="keep the traced window's Chrome trace and kernel table here")
    return ap


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    from benchmark import harness
    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
