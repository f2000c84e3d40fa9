"""The prediction entries: from crops (`predict`) and from uncropped photos
through HRNet (`predict_uncropped`), and how their outputs are judged.

Each entry builds the program's objects from the inputs of inputs.py, runs
one call of the program's public entry per `call(i)` on pool batch i mod P,
and in a traced run the same call split at the layers' public entries with
a span around each.  `reference(kept, precision)` runs the plain reference
on a kept batch; `numbers(got, want)` gives the widest gaps that decide
`correct`.
"""

import importlib
import math

import numpy as np
import torch

from ..reference import crop as ref_crop
from ..reference import hrnet as ref_hrnet
from ..reference import humaniflow as ref_hf
from ..reference.common import precision as ref_precision
from . import inputs
from .cell import port_config


def worst(values) -> float:
    """The largest of `values`; infinite when one is NaN (Python's max would
    keep a NaN out whenever it is not first)."""
    values = [float(v) for v in values]
    return math.inf if any(math.isnan(v) for v in values) else max(values)


def _max_abs(a, b) -> float:
    return worst([(a.float() - b.float()).abs().max()])


def prediction_numbers(got: dict, want: dict) -> dict:
    """The widest gaps between two predictions of one batch: the proxy, the
    heads, the rotations (point estimate and samples), the vertices and joints
    in metres (point estimate, T-pose, samples), and the per-vertex
    uncertainty relative to its largest reference value."""
    unc = worst(_max_abs(got[k], want[k]) / float(want[k].abs().max())
                for k in ("vertex_uncertainty_l2", "vertex_uncertainty_directional"))
    return {
        "proxy": _max_abs(got["proxy_rep"], want["proxy_rep"]),
        "heads": worst(_max_abs(got[k], want[k]) for k in ("cam_wp", "glob_rotmat", "shape_mode", "shape_log_std")),
        "rotations": worst(_max_abs(got[k], want[k]) for k in ("pose_rotmats_point_est", "pose_rotmats_samples")),
        "vertices": worst(_max_abs(got[k], want[k]) for k in (
            "verts_point_est", "tpose_verts", "verts_samples", "joints_point_est", "joints_samples")),
        "uncertainty": unc,
    }


class Predict:
    """`predict_humaniflow` on B cropped images with keypoints and
    confidences, N samples, explicit base noise; the images come from the
    host, as a caller's crops do."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from humaniflow_torch.models.humaniflow import HumaniflowModel
        from humaniflow_torch.models.smpl import smpl_from_numpy

        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.cfg = port_config(config)
        self.b, self.n = traffic["batch"], traffic["num_samples"]
        g = torch.Generator(self.device).manual_seed(seed)
        arrays = inputs.body_model(config["SMPL"]["NUM_VERTS"], config["SMPL"]["NUM_BETAS"], seed)
        self.smpl_ref = inputs.body_model_on(arrays, self.device)
        self.smpl = smpl_from_numpy(arrays, device=self.device)
        self.weights = inputs.draw_weights(inputs.humaniflow_spec(config["MODEL"]), g, self.device)
        self.model = HumaniflowModel(self.cfg.MODEL, device=self.device)
        self.model.load_state_dict(self.weights)
        self.levels = [len(lv) for lv in ref_hf.ancestors()[1]]
        self.pool = [self._make_batch(g) for _ in range(traffic["pool"])]

    def _make_batch(self, g):
        images, j2d, conf = inputs.crop_batch(self.b, self.config["DATA"]["PROXY_REP_SIZE"], g, self.device)
        noise = inputs.level_noise(self.b, self.n, self.levels, g, self.device)
        host = lambda t: t.cpu().numpy()  # noqa: E731
        return {"images": host(images), "joints2d": host(j2d), "conf": host(conf), "noise": noise}

    images_per_call = property(lambda self: self.b)

    def call(self, i: int) -> dict:
        from humaniflow_torch.pipelines.predict import predict_humaniflow

        x = self.pool[i % len(self.pool)]
        return predict_humaniflow(self.model, self.smpl, self.cfg, x["images"], x["joints2d"], x["conf"],
                                  num_samples=self.n, base_noise=x["noise"], device=self.device)

    def traced_call(self, i: int, span) -> dict:
        x = self.pool[i % len(self.pool)]
        return self._traced_predict(x["images"], x["joints2d"], x["conf"], x["noise"], span)

    def _traced_predict(self, images, joints2d, conf, noise, span):
        from humaniflow_torch.pipelines.predict import build_proxy_representation, make_predict_fn

        as_t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        with span("proxy_ms"):
            proxy = build_proxy_representation(as_t(images).to(torch.float32), as_t(joints2d), as_t(conf), self.cfg)
        with span("dist_infer_ms"):
            pred = make_predict_fn(self.model, self.smpl, self.cfg, num_samples=self.n, device=self.device)(
                proxy, None, noise)
        pred["proxy_rep"] = proxy
        return pred

    def keep(self, i: int, out: dict):
        return i % len(self.pool), out

    def judged(self, kept: list) -> list:
        """The kept calls of the window are what is judged."""
        return kept

    def control_kept(self) -> list:
        """The pool batches the control is judged on: as many as a run judges."""
        return [(p, None) for p in range(min(self.traffic["check_calls"], self.traffic["pool"]))]

    def free(self):
        del self.model, self.smpl

    def reference(self, kept, precision: str, judged=None) -> dict:
        """The reference's prediction of kept batch (pool index, output) in
        `precision`; `judged` (the side being judged) is not read here."""
        p, _ = kept
        x = self.pool[p]
        as_t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        with torch.no_grad(), ref_precision(precision):
            return ref_hf.predict(self.weights, self.smpl_ref, self.config, as_t(x["images"]),
                                  as_t(x["joints2d"]), as_t(x["conf"]), x["noise"])

    def numbers(self, got: dict, want: dict) -> dict:
        return prediction_numbers(got, want)


class PredictUncropped(Predict):
    """What the predict CLI does with uncropped photos: `predict_hrnet_batch`
    on B photos of two sizes with their person boxes (one HRNet pass), the
    square crop of each HRNet crop to the proxy size (`batch_crop_affine`),
    then `predict_humaniflow` on the crops, keypoints and confidences."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from humaniflow_torch.models.hrnet import PoseHighResolutionNet

        super().__init__(config, traffic, seed, device)
        hr = config["HRNET"]
        g = torch.Generator(self.device).manual_seed(seed + 1)
        self.hrnet_weights = inputs.draw_weights(inputs.hrnet_spec(hr), g, self.device)
        dtype = {"bf16": torch.bfloat16, "float32": None}[hr["DTYPE"]]
        self.hrnet = PoseHighResolutionNet(num_joints=hr["NUM_JOINTS"], dtype=dtype, device=self.device)
        self.hrnet.load_state_dict(self.hrnet_weights)

    def _make_batch(self, g):
        sizes = self.traffic["photo_hw"]
        photos, boxes = [], []
        for k in range(self.b):
            img, box = inputs.uncropped_photo(*sizes[k % len(sizes)], g, self.device)
            photos.append(img.cpu().numpy())
            boxes.append(box)
        noise = inputs.level_noise(self.b, self.n, self.levels, g, self.device)
        return {"photos": photos, "boxes": boxes, "noise": noise}

    def _hrnet_then_crop(self, x, span):
        ph = importlib.import_module("humaniflow_torch.pipelines.predict_hrnet")
        from humaniflow_torch.data.image_ops import batch_crop_affine

        with span("hrnet_stage_ms"):
            hr = ph.predict_hrnet_batch(self.hrnet, x["photos"], bboxes=x["boxes"], device=self.device)
        in_w, in_h = self.config["HRNET"]["INPUT_WH"]
        side, n, wh = float(max(in_w, in_h)), self.b, self.config["DATA"]["PROXY_REP_SIZE"]
        crop = batch_crop_affine(
            (wh, wh), rgb=hr["cropped_images"], joints2d=hr["joints2D"],
            bbox_centres=torch.tensor([in_h / 2.0, in_w / 2.0], device=self.device).expand(n, 2),
            bbox_heights=torch.full((n,), side, device=self.device),
            bbox_widths=torch.full((n,), side, device=self.device), orig_scale_factor=1.0)
        return hr, crop

    def call(self, i: int) -> dict:
        from humaniflow_torch.pipelines.predict import predict_humaniflow

        x = self.pool[i % len(self.pool)]
        hr, crop = self._hrnet_then_crop(x, _no_span)
        pred = predict_humaniflow(self.model, self.smpl, self.cfg, crop["rgb"], crop["joints2d"], hr["joints2Dconfs"],
                                  num_samples=self.n, base_noise=x["noise"], device=self.device)
        return _with_stage(pred, hr, crop)

    def traced_call(self, i: int, span) -> dict:
        x = self.pool[i % len(self.pool)]
        hr, crop = self._hrnet_then_crop(x, span)
        pred = self._traced_predict(crop["rgb"], crop["joints2d"], hr["joints2Dconfs"], x["noise"], span)
        return _with_stage(pred, hr, crop)

    def free(self):
        super().free()
        del self.hrnet

    def reference(self, kept, precision: str, judged=None) -> dict:
        """The reference's HRNet stage on the photos and boxes, then its crops
        and prediction.  HRNet's argmax keypoints and confidences are
        discrete answers that the numbers judge on the reference heatmaps
        (`hrnet`); the crops and the prediction that follow take those of
        `judged` (the judged side's own), as a served model's tokens
        are scored on the reference's logits.  Without `judged` (the control,
        which stands in the program's place), the reference decodes its own."""
        p, _ = kept
        x, hr_cfg = self.pool[p], self.config["HRNET"]
        dev = self.device
        boxes = (torch.tensor([b[0] for b in x["boxes"]], device=dev),
                 torch.tensor([b[1] for b in x["boxes"]], device=dev, dtype=torch.float32),
                 torch.tensor([b[2] for b in x["boxes"]], device=dev, dtype=torch.float32))
        by_size = {}
        for k, img in enumerate(x["photos"]):
            by_size.setdefault(img.shape, []).append(k)
        groups = [(idx, torch.stack([torch.as_tensor(x["photos"][k], device=dev) for k in idx]))
                  for idx in by_size.values()]
        hr_dtype = hr_cfg["DTYPE"] if precision == "float32" else "fp8"
        with torch.no_grad(), ref_precision(precision):
            crops384, heat = ref_hrnet.keypoint_stage(self.hrnet_weights, hr_cfg, groups, boxes, hr_dtype)
            if judged is None:
                kp, conf = decode(heat, hr_cfg)
            else:
                kp, conf = judged["joints2D"], judged["joints2Dconfs"]
            in_w, in_h = hr_cfg["INPUT_WH"]
            n, wh, side = self.b, self.config["DATA"]["PROXY_REP_SIZE"], float(max(in_w, in_h))
            rgb, j2d, _, _ = ref_crop.crop_affine(
                (wh, wh), crops384, torch.tensor([in_h / 2.0, in_w / 2.0], device=dev).expand(n, 2),
                torch.full((n,), side, device=dev), torch.full((n,), side, device=dev), 1.0, joints2d=kp)
            out = ref_hf.predict(self.weights, self.smpl_ref, self.config, rgb, j2d, conf, x["noise"])
        out.update(cropped_images=crops384, crop_rgb=rgb, heatmaps=heat, joints2D=kp, joints2Dconfs=conf)
        return out

    def numbers(self, got: dict, want: dict) -> dict:
        return {"hrnet": hrnet_gap(got, want, self.config["HRNET"]),
                "crops": worst([_max_abs(got["cropped_images"], want["cropped_images"]),
                                _max_abs(got["crop_rgb"], want["crop_rgb"])]),
                **prediction_numbers(got, want)}


def _no_span(name):
    import contextlib

    return contextlib.nullcontext()


def _with_stage(pred, hr, crop):
    pred.update(joints2D=hr["joints2D"], joints2Dconfs=hr["joints2Dconfs"], cropped_images=hr["cropped_images"],
                crop_rgb=crop["rgb"])
    return pred


def decode(heat, hr_cfg):
    """Argmax keypoints (N, K, 2) in input-crop pixels and confidences (N, K)
    of (N, h, w, K) heatmaps; a tie goes to the first maximum."""
    n, h, w, k = heat.shape
    flat = heat.reshape(n, h * w, k)
    conf, idx = flat.amax(dim=1), flat.argmax(dim=1)
    kp = torch.stack([(idx % w).float(), torch.floor(idx.float() / w)], dim=-1)
    return kp * (hr_cfg["INPUT_WH"][0] / hr_cfg["HEATMAP_WH"][0]), conf


def hrnet_gap(got, want, hr_cfg) -> float:
    """The widest of (a) a confidence's gap to the reference heatmap's maximum
    and (b) the gap by which the reference heatmap at the judged keypoint lies
    below that maximum, over every keypoint, relative to the largest
    reference confidence."""
    heat = want["heatmaps"]
    n, h, w, k = heat.shape
    best = heat.reshape(n, h * w, k).amax(dim=1)
    cell = torch.round(got["joints2D"] * (hr_cfg["HEATMAP_WH"][0] / hr_cfg["INPUT_WH"][0])).long()
    inside = (cell[..., 0] >= 0) & (cell[..., 0] < w) & (cell[..., 1] >= 0) & (cell[..., 1] < h)
    cell = torch.where(inside[..., None], cell, torch.zeros_like(cell))
    at = heat[torch.arange(n, device=heat.device)[:, None], cell[..., 1], cell[..., 0],
              torch.arange(k, device=heat.device)[None, :]]
    at = torch.where(inside, at, torch.full_like(at, -np.inf))
    gap = torch.maximum((best - at), (got["joints2Dconfs"] - best).abs())
    return worst([gap.max() / best.abs().max()])

