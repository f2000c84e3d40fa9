"""Readings that a cell's limits are set from, in one process:

    python3 -m benchmark.harness.calibrate --workload <name> --seeds 1,2,... --control-seeds 1,2,3

For each seed of --seeds: the cell's set-up from that seed, `calls` calls of
its entry (as many as a run judges, and more), the kept ones judged against
the reference as a run judges them: the sound program's readings.  For each
seed of --control-seeds: the control, the reference itself one precision
step below the configuration's (TF32 for float32; fp8 for bf16), in the
program's place, judged the same way.  One JSON line a seed.  Needs the
card; the CPU runs it too, where TF32 does not exist, so only the sound
readings mean something there.
"""

import argparse
import json
import random
import sys


def readings(cell, seed: int, device="cuda", calls: int = None) -> dict:
    """The sound program's numbers on one seed: a short closed loop, the
    kept calls judged as a run judges them."""
    from benchmark.harness.cell import make_entry
    from benchmark.harness.trace import sync
    from benchmark.run import Reservoir, judge

    entry = make_entry(cell, seed, device)
    keep = Reservoir(cell.traffic["check_calls"], random.Random(seed))
    for i in range(calls or 2 * cell.traffic["check_calls"]):
        out = entry.call(i)
        sync(device)
        keep.offer(lambda: entry.keep(i, out))
    entry.free()
    return {k: c["value"] for k, c in judge(entry, keep.items, cell.traffic["limits"]).items()}


def control_readings(cell, seed: int, device="cuda") -> dict:
    """The control's numbers on one seed: the reference in the lower
    precision in the program's place, on the pool batches a run would keep."""
    from benchmark.harness.cell import make_entry

    entry = make_entry(cell, seed, device)
    entry.free()
    return _worst(entry, lambda item: entry.reference(item, "tf32"))


def fault_readings(cell, seed: int, fault: str, device="cuda") -> dict:
    """The numbers of a fault planted in the reference put in the program's
    place (an entry's `faults`; training's "half": the loss over half of
    each batch)."""
    from benchmark.harness.cell import make_entry

    entry = make_entry(cell, seed, device)
    entry.free()
    return _worst(entry, lambda item: entry.reference(item, "float32", fault=fault))


def _worst(entry, stand_in) -> dict:
    items = entry.judged(entry.control_kept())
    worst = {}
    for item in items:
        got = stand_in(item)
        want = entry.reference(item, "float32", judged=got)
        for name, v in entry.numbers(got, want).items():
            if name in entry.traffic["limits"]:
                worst[name] = max(worst.get(name, v), v)
    return worst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from benchmark.harness.cell import load_cell

    cell = load_cell(args.workload)
    for s in filter(None, args.seeds.split(",")):
        print(json.dumps({"seed": int(s), "side": "program", **readings(cell, int(s), args.device)}), flush=True)
    for s in filter(None, args.control_seeds.split(",")):
        print(json.dumps({"seed": int(s), "side": "control", **control_readings(cell, int(s), args.device)}),
              flush=True)
    from benchmark.harness.cell import entry_class

    for fault in getattr(entry_class(cell.traffic["entry"]), "faults", ()):
        for s in filter(None, args.fault_seeds.split(",")):
            print(json.dumps({"seed": int(s), "side": f"fault:{fault}", **fault_readings(cell, int(s), fault,
                                                                                      args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
