"""Run one cell of the benchmark of clfacedetection_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA card(s) the cell
asks for.  The last line of standard output is the result, one JSON
object; the numbers compared with the reference, each beside its limit,
are the last lines of standard error.  Exits 2 without a card, 3 where a
module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    from portbench.harness.bench import NoCard, run
    from portbench.harness.cell import forbidden_modules
    try:
        result = run(a.workload, a.seed, a.seconds, bool(a.trace), T_START)
    except NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"no result: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
