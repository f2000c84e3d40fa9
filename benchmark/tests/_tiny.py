"""Cells cut to a size the CPU runs in seconds: every width as published,
B = 2, N = 3, one pool batch, small photos (HRNet still sees 384×288 crops),
synthetic batches of 64² from small texture atlases."""

from benchmark.harness.cell import load_cell

SEED = 2 ** 33 + 7  # wider than 32 bits, as the driver's seeds are


def tiny_cell(workload: str):
    cell = load_cell(workload)
    cell.traffic.update(batch=2, num_samples=3, pool=1, check_calls=1, profiled_calls=1)
    if "photo_hw" in cell.traffic:
        cell.traffic["photo_hw"] = [[96, 128], [120, 90]]
    if "texture_hw" in cell.traffic:  # a synthetic batch at 64², the body framed as at 256²
        cell.traffic["texture_hw"] = [60, 40]
        cell.config["DATA"]["PROXY_REP_SIZE"] = 64
        cell.config["TRAIN"]["SYNTH_DATA"]["FOCAL_LENGTH"] = 75.0
    return cell


def workloads():
    import json
    import os

    from benchmark.harness.cell import REPO_ROOT

    with open(os.path.join(REPO_ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]
