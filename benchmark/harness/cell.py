"""A cell of BENCHMARK.json: its configuration file, its traffic file and its
metrics, found by name.

The traffic file names the entry class that drives the program (`entry`,
"<module>:<class>", a module under benchmark/), its shapes and pool sizes,
and the limits of the numbers that decide `correct`.  A new cell is a new
entry in BENCHMARK.json plus, where it needs them, a new configuration file
(benchmark/configs/<name>.json), a new traffic file
(benchmark/traffic/<name>.json) and a new entry module; a new metric, end
to end or per layer, is a new reader, benchmark/metrics/<name>.py.
"""

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # metric entries of BENCHMARK.json reported by this cell
    per_layer: list


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench_path: str = None) -> Cell:
    bench = _load_json(bench_path or os.path.join(REPO_ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(REPO_ROOT, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    return Cell(
        name=workload, chips=w["chips"], config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
    )


def entry_class(spec: str):
    """The class a traffic file names as its entry, "<module>:<class>"."""
    module, _, name = spec.partition(":")
    if not module.startswith("benchmark.") or not name:
        raise ValueError(f"an entry is '<module under benchmark/>:<class>', not {spec!r}")
    return getattr(importlib.import_module(module), name)


def make_entry(cell: Cell, seed: int, device):
    """The cell's entry object: its set-up from the seed."""
    return entry_class(cell.traffic["entry"])(cell.config, cell.traffic, seed, device)


def metric_reader(name: str):
    """read(run) of benchmark/metrics/<name>.py."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def roofline(name: str):
    """The module benchmark/roofline/<name>.py."""
    return importlib.import_module(f"benchmark.roofline.{name}")


def port_config(config: dict):
    """The program's HumaniflowConfig with the configuration file's groups
    (MODEL, DATA, TRAIN, LOSS) laid over its defaults; every key must exist."""
    from humaniflow_torch.configs.defaults import get_humaniflow_cfg_defaults

    cfg = get_humaniflow_cfg_defaults()

    def lay(obj, d, path):
        for k, v in d.items():
            if not hasattr(obj, k):
                raise KeyError(f"the program's config has no {path}{k}")
            cur = getattr(obj, k)
            if isinstance(v, dict):
                lay(cur, v, f"{path}{k}.")
            else:
                setattr(obj, k, tuple(tuple(x) if isinstance(x, list) else x for x in v) if isinstance(v, list) else v)

    for group in ("MODEL", "DATA", "TRAIN", "LOSS"):
        if group in config:
            lay(getattr(cfg, group), config[group], f"{group}.")
    return cfg
