"""A run with the timed path broken underneath comes out not correct: the
whole run at a tiny size on the CPU, with each fault a cell can have planted
in the program: one answer altered where it is produced (a vertex, a
keypoint, a rendered image), half of the samples or of the batch left out
of a mean, a training step that leaves its state unchanged.  (No cell runs on several chips, so none can leave out an
exchange between them.)"""

import importlib

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests._tiny import SEED, tiny_cell, workloads


def _altered_vertices(monkeypatch):
    """K2's output (the plain twin on the CPU) off by 1 mm in one coordinate."""
    from humaniflow_torch.models import cuda_lbs

    real = cuda_lbs.smpl_verts

    def altered(*args):
        out = real(*args).clone()
        out[0, 0, 0] += 1e-3
        return out

    monkeypatch.setattr(cuda_lbs, "smpl_verts", altered)


def _half_the_samples(monkeypatch):
    """The per-vertex uncertainty from the first half of the samples only."""
    from humaniflow_torch.pipelines import predict
    from humaniflow_torch.utils.sampling import compute_vertex_variance_from_samples as real

    monkeypatch.setattr(predict, "compute_vertex_variance_from_samples",
                        lambda v: real(v[:, : max(1, v.shape[1] // 2)]))


def _altered_keypoint(monkeypatch):
    """HRNet's first keypoint of every image moved by half the heatmap's width."""
    ph = importlib.import_module("humaniflow_torch.pipelines.predict_hrnet")
    real = ph.get_kp_locations_confs_from_heatmaps

    def altered(heatmaps):
        kp, conf = real(heatmaps)
        kp = kp.clone()
        kp[:, 0, 0] = (kp[:, 0, 0] + heatmaps.shape[2] // 2) % heatmaps.shape[2]
        return kp, conf

    monkeypatch.setattr(ph, "get_kp_locations_confs_from_heatmaps", altered)


def _state_unchanged(monkeypatch):
    """Adam's step does nothing."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_the_batch(monkeypatch):
    """The training loss over the first half of the batch only."""
    from humaniflow_torch.pipelines import train_step

    real = train_step.humaniflow_loss

    def half(loss_cfg, img_wh, pred, target, group=None):
        cut = lambda d: {k: v[: max(1, v.shape[0] // 2)] for k, v in d.items()}  # noqa: E731
        return real(loss_cfg, img_wh, cut(pred), cut(target), group)

    monkeypatch.setattr(train_step, "humaniflow_loss", half)


def _altered_render(monkeypatch):
    """K4's lit colours (its plain twin on the CPU) brighter by 0.2."""
    from humaniflow_torch.render import renderer

    real = renderer.rasterize_with_attrs

    def altered(*args, **kwargs):
        frags, planes, overflow, drop = real(*args, **kwargs)
        planes = planes.clone()
        planes[..., :3] += 0.2
        return frags, planes, overflow, drop

    monkeypatch.setattr(renderer, "rasterize_with_attrs", altered)


FAULTS = {"altered_vertices": (_altered_vertices, "vertices"),
          "altered_render": (_altered_render, "synth_images"),
          "half_the_samples": (_half_the_samples, "uncertainty"),
          "altered_keypoint": (_altered_keypoint, "hrnet"),
          "state_unchanged": (_state_unchanged, "change"),
          "half_the_batch": (_half_the_batch, "loss")}


# each cell with each fault it can have: one whose number it compares
CASES = [(w, f) for w in workloads() for f in sorted(FAULTS) if FAULTS[f][1] in tiny_cell(w).traffic["limits"]]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    cell = tiny_cell(workload)
    plant, number = FAULTS[fault]
    cell.traffic["num_samples"] = 4  # two samples left of four: the mean moves
    cell.traffic["batch"] = 4  # two images left of four
    torch.manual_seed(0)
    plant(monkeypatch)
    r = run_cell(cell, SEED, 0.3, False, device="cpu")
    assert not r["correct"]
    assert r["checked"][number]["value"] > r["checked"][number]["limit"], r["checked"]
