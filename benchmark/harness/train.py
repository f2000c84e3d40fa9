"""The training entry (`TrainSynth`): what `train_humaniflow` does per
batch, `make_synth_data_fn`'s synthetic batch (SMPL targets, the render
through kernel K4 with per-face texels and culling, the crop, the
augmentations, Canny and heatmaps) and then `make_train_step`'s step with
`update=True`, and how both are judged.

Set-up builds one object, the synthetic-data function, the step with its
model and Adam's state, and the pools of poses, texture atlases and
backgrounds, and drives it from the seed through its first three steps on
three different pool batches, through the window's own call: the batches
the synthetic-data function made, the state of its random source before
each, the loss of each step, the first gradient as Adam got it (its first
moment after one step over 1 − β1) and the parameters after the third step
are kept.  The window goes on with the same object, its random source
drawing on.

Judged: the step, by the reference's three steps (reference/train.py) from
the same weights and noise on the program's own synthetic batches; the
synthetic batches (the three first ones and a sample of the window's),
image by image against the reference's batch from the same poses, atlases,
backgrounds and random state (reference/synth.py).
"""

import statistics

import torch

from ..reference import synth as ref_synth
from ..reference import train as ref_train
from ..reference.common import precision as ref_precision
from ..reference.humaniflow import ancestors
from . import inputs
from .cell import port_config
from .predict import worst

FIRST_STEPS = 3
MOVED = 1e-3  # leaves whose reference gradient is under this share of the median leaf's move by round-off alone
# an image of a synthetic batch disagrees with the reference's when a joint's
# visibility differs, a 2D joint lies JOINT_PX or more pixels away, or more
# than VALUE_SHARE of its proxy's values (or of its RGB's) differ by VALUE_GAP or more
JOINT_PX = 0.05
VALUE_GAP = 1e-3
VALUE_SHARE = 0.01
TARGETS = ("pose_rotmats", "glob_rotmats", "shape")


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def images_apart(got: dict, want: dict) -> torch.Tensor:
    """(B,) bool: the images of two synthetic batches that disagree."""
    b = want["proxy"].shape[0]
    vis = (got["joints2D_vis"] != want["joints2D_vis"]).any(dim=1)
    joints = (got["joints2D"] - want["joints2D"]).abs().reshape(b, -1)
    joints = ~(joints < JOINT_PX).all(dim=1)  # a NaN is apart
    share = lambda k: (~((got[k] - want[k]).abs() < VALUE_GAP)).reshape(b, -1).float().mean(dim=1)  # noqa: E731
    return vis | joints | (share("proxy") > VALUE_SHARE) | (share("rgb_in") > VALUE_SHARE)


def synth_numbers(got: dict, want: dict) -> dict:
    """synth_targets: the widest gap of the target rotations and shapes;
    synth_images: the share of the batch's images that disagree
    (images_apart)."""
    return {"synth_targets": worst(float((got[k] - want[k]).abs().max()) for k in TARGETS),
            "synth_images": float(images_apart(got, want).float().mean())}


class TrainSynth:
    """The synthetic batch at B images from pool batch i mod P, then
    `make_train_step(model, smpl, cfg.LOSS, Adam)` on it with
    NUM_J2D_SAMPLES samples of explicit noise."""

    images_per_call = property(lambda self: self.b)
    faults = ("half",)

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from humaniflow_torch.data.augmentation import Draws
        from humaniflow_torch.models.humaniflow import HumaniflowModel
        from humaniflow_torch.models.smpl import smpl_from_numpy
        from humaniflow_torch.pipelines.train import make_optimizer, make_synth_data_fn, make_training_renderer
        from humaniflow_torch.pipelines.train_step import make_train_step

        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.cfg = port_config(config)
        self.b, nb = traffic["batch"], config["MODEL"]["NUM_SMPL_BETAS"]
        self.n = config["LOSS"]["NUM_J2D_SAMPLES"]
        size = config["DATA"]["PROXY_REP_SIZE"]
        g = torch.Generator(self.device).manual_seed(seed)
        arrays = inputs.body_model(config["SMPL"]["NUM_VERTS"], config["SMPL"]["NUM_BETAS"], seed)
        self.smpl_ref = inputs.body_model_on(arrays, self.device)
        self.smpl = smpl_from_numpy(arrays, device=self.device)
        self.weights = inputs.draw_weights(inputs.humaniflow_spec(config["MODEL"]), g, self.device)
        self.model = HumaniflowModel(self.cfg.MODEL, device=self.device)
        self.model.load_state_dict(self.weights)
        self.optimizer = make_optimizer(self.model, self.cfg)
        self.step = make_train_step(self.model, self.smpl, self.cfg.LOSS, self.optimizer, img_wh=size)
        renderer = make_training_renderer(self.cfg, cull=True, device=self.device)
        if self.device.type == "cpu":
            # the renderer routes the CPU to the exact scan with per-pixel texels; a rehearsal
            # there renders as the card does, through K4's plain twin with per-face texels
            renderer.rasterizer = "binned"
        self.synth = make_synth_data_fn(self.cfg, self.smpl, renderer)
        levels = [len(lv) for lv in ancestors()[1]]
        pool = max(traffic["pool"], FIRST_STEPS)
        self.pool = [inputs.synth_inputs(self.b, size, traffic["pose_std"], traffic["texture_hw"], g, self.device)
                     for _ in range(pool)]
        self.noise = [(torch.randn((self.b, self.n, nb), generator=g, device=self.device),
                       inputs.level_noise(self.b, self.n, levels, g, self.device)) for _ in range(pool)]
        self.source = torch.Generator(self.device).manual_seed(seed + 2)
        self.draws = Draws(self.source)
        self.first = self._first_steps()

    def _first_steps(self) -> dict:
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        named = dict(self.model.named_parameters())
        losses, grad1, batches = [], None, []
        for i in range(FIRST_STEPS):
            out = self.call(i)
            losses.append(float(out["total"]))
            batches.append(self.keep(i, out))
            if i == 0:
                grad1 = {k: self.optimizer.state[p]["exp_avg"] / (1.0 - beta1) for k, p in named.items()}
        return {"losses": losses, "grad1": _norms(grad1), "batches": batches,
                "change": _norms({k: p.detach() - self.weights[k] for k, p in named.items()})}

    def call(self, i: int) -> dict:
        state = self.source.get_state()
        batch = self._synth(i)
        out = self.step({k: v for k, v in batch.items() if k not in ("rgb_in", "binning_overflow")},
                        noise=self.noise[i % len(self.noise)])
        out.update(batch=batch, state=state)
        return out

    def _synth(self, i: int) -> dict:
        x = self.pool[i % len(self.pool)]
        return self.synth(self.draws, x["pose"], x["texture"], x["background"])

    def traced_call(self, i: int, span) -> dict:
        state = self.source.get_state()
        with span("synth_ms"):
            batch = self._synth(i)
        with span("train_step_ms"):
            out = self.step({k: v for k, v in batch.items() if k not in ("rgb_in", "binning_overflow")},
                            noise=self.noise[i % len(self.noise)])
        out.update(batch=batch, state=state)
        return out

    def keep(self, i: int, out):
        """(pool index, random state before the batch, the batch)."""
        return i % len(self.pool), out["state"], out["batch"]

    def judged(self, kept: list) -> list:
        """The first steps with their batches, kept at set-up, and the
        window's kept batches."""
        return [("steps", self.first)] + [("batch", item) for item in kept]

    def control_kept(self) -> list:
        """What the control is judged on besides the first steps: nothing."""
        return []

    def free(self):
        del self.model, self.smpl, self.optimizer, self.step, self.synth

    def _reference_batch(self, kept) -> dict:
        p, state, _ = kept
        x = self.pool[p]
        with torch.no_grad():
            return ref_synth.synth_batch(state, x["pose"], x["texture"], x["background"], self.smpl_ref,
                                         self.config, inputs.UV_MAT)

    def reference(self, item, precision: str, judged=None, fault: str = None) -> dict:
        """The reference's side of a judged item in `precision`: for the
        first steps, its three steps from the same weights and noise on the
        batches the judged side made (`judged`, the program's own when
        judging the program) and its own synthetic batches; for a window's
        batch, its own.  fault="half": the reference's loss taken over the
        first half of each batch only (a planted fault)."""
        kind, got = item
        with ref_precision(precision):
            if kind == "batch":
                return self._reference_batch(got)
            batches = [self._reference_batch(k) for k in got["batches"]]
            train_on = judged["batches"] if judged is not None else [(None, None, b) for b in batches]
            w = {k: v.clone() for k, v in self.weights.items()}
            trainable = [k for k in w if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
            adam = ref_train.Adam({k: w[k] for k in trainable}, lr=self.config["TRAIN"]["LR"])
            losses, grad1 = [], None
            for i in range(FIRST_STEPS):
                batch = {k: v for k, v in train_on[i][2].items() if k not in ("rgb_in", "binning_overflow")}
                noise = self.noise[i]
                if fault == "half":
                    h = self.b // 2
                    batch = {k: v[:h] for k, v in batch.items()}
                    noise = (noise[0][:h], [z[:h] for z in noise[1]])
                terms, grads = ref_train.train_step(w, trainable, self.smpl_ref, self.config, batch, noise, adam)
                losses.append(terms["total"])
                if i == 0:
                    grad1 = _norms(grads)
        return {"losses": losses, "grad1": grad1, "batches": [(None, None, b) for b in batches],
                "change": _norms({k: w[k] - self.weights[k] for k in trainable})}

    def numbers(self, got, want) -> dict:
        """For a window's batch: synth_numbers.  For the first steps: the
        worst synth_numbers of their batches, and loss: the widest relative
        gap of the three steps' losses; grad and change: the worst leaf's gap
        between the two sides' norms of the first gradient, and of the
        change over the three steps, each over the larger of the reference
        leaf's norm and the median leaf's; the change leaves out leaves whose
        reference gradient is under MOVED of the median leaf's (they move by
        round-off alone under Adam)."""
        if isinstance(got, tuple):  # a window's kept batch
            return synth_numbers(got[2], want)
        per_batch = [synth_numbers(g[2], w[2]) for g, w in zip(got["batches"], want["batches"])]
        loss = worst(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
        gmed = statistics.median(want["grad1"].values())
        grad = worst(abs(got["grad1"][k] - v) / max(v, gmed) for k, v in want["grad1"].items())
        moved = [k for k, v in want["grad1"].items() if v >= MOVED * gmed]
        cmed = statistics.median(want["change"][k] for k in moved)
        change = worst(abs(got["change"][k] - want["change"][k]) / max(want["change"][k], cmed) for k in moved)
        return {"loss": loss, "grad": grad, "change": change,
                **{k: worst(n[k] for n in per_batch) for k in per_batch[0]}}
