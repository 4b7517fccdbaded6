"""The control of a cell's check: the reference put in the program's place
with one guarantee broken, which the check has to find wrong.

    python3 -m pfbench.control --workload <name> --seeds <n> [<n> ...]

The guarantee is exact suffix order. The control's suffix sort stops
``SHORT`` doubling rounds before the reference's: suffixes are then
ordered by their first 2**(rounds - SHORT) characters, an eighth of the
depth the text needs, ties in text order. That is the step a build
tempted to cap its doubling would take. One round short would not do: it
leaves only the few longest repeats tied, and each of them comes out in
text order by chance with probability 1/2. For each seed it makes
the cell's inputs, works out the reference and the control on the card,
and prints the numbers that the check would compare; the last line is a
JSON object of every seed's numbers, with ``correct`` false for each seed
where the control is caught. The benchmark's own runs do not run this.
"""

import argparse
import importlib
import json
import shutil
import sys
import tempfile

from .run import NoCard, load_cell, require_cards

SHORT = 3


def control_numbers(workload: str, seed: int, device: str = "cuda",
                    overrides: dict = None) -> dict:
    _, config, traffic, _ = load_cell(workload, overrides)
    gen = importlib.import_module(f"pfbench.generators.{traffic['generator']}")
    drv = importlib.import_module(f"pfbench.drivers.{config['entry']}")
    workdir = tempfile.mkdtemp(prefix="pfbench-control-")
    try:
        inputs = gen.make(config, traffic, seed, workdir)
        want, sizes = drv.reference(config, inputs, device)
        ctrl, _ = drv.reference(config, inputs, device,
                                max_rounds=max(1, sizes["rounds"] - SHORT))
        numbers = drv.check(ctrl, want)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"seed": seed, "rounds": sizes["rounds"],
            "correct": not any(numbers.values()), "numbers": numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    try:
        require_cards(1)
    except NoCard as e:
        print(f"pfbench.control: {e}", file=sys.stderr)
        return 2
    out = []
    for seed in args.seeds:
        r = control_numbers(args.workload, seed)
        print(f"{args.workload} seed {seed}: reference rounds {r['rounds']},"
              f" control {r['numbers']}", file=sys.stderr)
        out.append(r)
    print(json.dumps({"workload": args.workload, "runs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
