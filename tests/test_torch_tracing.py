"""The port's spans and counters (utils/tracing.py) on the CPU: off, a
span is one shared object and nothing is recorded; on, a tiny
`predict_humaniflow`, `predict_hrnet_batch`, synthetic batch and train step
record every span of the program's table under its parent, with one call
id a root, children inside their parents and no custom-kernel launches off
the card; under torch.profiler every span is a host event of its name,
nested as recorded; the ring keeps the newest instances and the totals all
of them."""

import dataclasses
import importlib
from collections import Counter, defaultdict, deque

import numpy as np
import pytest
import torch
from _torch_parity import IMG, small_cfgs

from humaniflow_torch.data.augmentation import Draws
from humaniflow_torch.models import HumaniflowModel, PoseHighResolutionNet
from humaniflow_torch.models import smpl as tsmpl
from humaniflow_torch.pipelines import make_optimizer, make_synth_data_fn, make_train_step, predict_humaniflow
from humaniflow_torch.pipelines.train import make_training_renderer
from humaniflow_torch.utils import tracing
from humaniflow_torch.utils.profiling import StageTimer

tph = importlib.import_module("humaniflow_torch.pipelines.predict_hrnet")

B, N, NJ = 2, 3, 2
LEVELS = 8
# span -> its parent, per root (the table of PERF.md §3)
PARENTS = {
    "predict": {"predict": None, "predict.upload": "predict", "proxy": "predict", "proxy.edges": "proxy",
                "proxy.heatmaps": "proxy", "dist_infer": "predict", "encoder": "dist_infer", "heads": "dist_infer",
                "flow.sample": "dist_infer", "flow.level": "flow.sample", "smpl": "dist_infer",
                "variance": "dist_infer"},
    "hrnet": {"hrnet": None, "hrnet.upload": "hrnet", "hrnet.crop": "hrnet", "crop": "hrnet.crop",
              "hrnet.net": "hrnet", "hrnet.decode": "hrnet", "hrnet.fallback": "hrnet"},
    "synth": {"synth": None, "synth.smpl": "synth", "synth.render": "synth", "synth.crop": "synth",
              "crop": "synth.crop", "synth.augment": "synth", "synth.proxy": "synth"},
    "train_step": {"train_step": None, "train_step.forward": "train_step", "encoder": "train_step.forward",
                   "heads": "train_step.forward", "flow.sample": "train_step.forward", "flow.level": "flow.sample",
                   "train_step.backward": "train_step", "train_step.check": "train_step",
                   "train_step.optimizer": "train_step"},
}
LAUNCH_NAMES = {"smpl_verts", "smpl_moments", "smpl_verts_backward", "lbs_skin", "coverage", "flow_level", "raster",
                "tiled_raster"}


@pytest.fixture(scope="module")
def programs():
    """The four calls of the program at tiny sizes, each a function of no
    arguments."""
    _, cfg = small_cfgs()
    model = HumaniflowModel(cfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(3))
    smpl = tsmpl.synthetic_smpl(num_verts=6890, device="cpu")
    rng = np.random.default_rng(4)
    images = rng.uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    j2d = rng.uniform(0, IMG, size=(B, 17, 2)).astype(np.float32)
    conf = rng.uniform(size=(B, 17)).astype(np.float32)

    hrnet = PoseHighResolutionNet(device="cpu")
    photos = [rng.uniform(size=(40, 30, 3)).astype(np.float32), rng.uniform(size=(36, 52, 3)).astype(np.float32)]

    sd = dataclasses.replace(cfg.TRAIN.SYNTH_DATA, FOCAL_LENGTH=300.0 * IMG / 256.0)
    cfg.TRAIN = dataclasses.replace(cfg.TRAIN, SYNTH_DATA=sd)
    synth = make_synth_data_fn(cfg, smpl, make_training_renderer(cfg, device="cpu"))
    pose = torch.as_tensor(rng.normal(scale=0.3, size=(B, 72)).astype(np.float32))
    texture = torch.as_tensor(rng.uniform(size=(B, 60, 40, 3)).astype(np.float32))
    background = torch.as_tensor(rng.uniform(size=(B, IMG, IMG, 3)).astype(np.float32))

    step = make_train_step(model, smpl, cfg.LOSS, make_optimizer(model, cfg), img_wh=IMG, num_j2d_samples=NJ)
    batch = synth(Draws(torch.Generator().manual_seed(5)), pose, texture, background)
    batch = {k: v for k, v in batch.items() if k not in ("rgb_in", "binning_overflow")}

    return {
        "predict": lambda: predict_humaniflow(model, smpl, cfg, images, j2d, conf, num_samples=N, device="cpu"),
        "hrnet": lambda: tph.predict_hrnet_batch(hrnet, photos, device="cpu"),
        "synth": lambda: synth(Draws(torch.Generator().manual_seed(5)), pose, texture, background),
        "train_step": lambda: step(batch, generator=torch.Generator().manual_seed(6)),
    }


@pytest.fixture(scope="module")
def small_hrnet_input():
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tph, "HRNET_INPUT_WH", (64, 96))
        m.setattr(tph, "HRNET_HEATMAP_WH", (16, 24))
        yield


@pytest.fixture(scope="module")
def traced(programs, small_hrnet_input):
    """Each program run once with tracing on: root name -> its span records."""
    out = {}
    for root, fn in programs.items():
        tracing.reset()
        with tracing.tracing():
            fn()
        out[root] = tracing.records()
    tracing.reset()
    return out


def test_off_a_span_is_one_shared_object_and_records_nothing():
    tracing.reset()
    assert not tracing.enabled()
    a, b = tracing.span("predict"), tracing.span("hrnet.upload")
    assert a is b
    with tracing.span("x") as s, tracing.span("y"):
        tracing.count("h2d_bytes", 5)
    assert s is a
    assert tracing.records() == [] and tracing.summary() == {}


def test_the_private_profiler_names_the_spans_use_exist():
    """The spans look up two private names of torch on use; a torch that
    renames either fails here, not at `import humaniflow_torch`."""
    import torch.autograd.profiler as profiler

    assert isinstance(profiler._is_profiler_enabled, bool)
    assert callable(torch._C._profiler._RecordFunctionFast)
    with tracing._range("x") as r:
        assert r is not tracing._NO_SPAN


@pytest.mark.parametrize("root", list(PARENTS))
def test_every_span_under_its_parent(traced, root):
    recs = traced[root]
    by_id = {r.id: r for r in recs}
    want = PARENTS[root]
    got = {}
    for r in recs:
        parent = by_id[r.parent].name if r.parent is not None else None
        got.setdefault(r.name, set()).add(parent)
    assert set(got) == set(want), set(got) ^ set(want)
    for name, parents in got.items():
        if name == "crop" and root == "hrnet":
            continue  # one per hrnet.crop
        allowed = {want[name], "hrnet.fallback"} if root == "hrnet" else {want[name]}
        assert parents <= allowed, (name, parents)
    if root == "hrnet":  # the fallback pass runs where no box was given
        assert {by_id[r.parent].name for r in recs if r.name in ("hrnet.net", "hrnet.decode")} <= {"hrnet",
                                                                                                 "hrnet.fallback"}


@pytest.mark.parametrize("root", list(PARENTS))
def test_call_ids_nesting_self_time_and_no_launches_off_the_card(traced, root):
    recs = traced[root]
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == [root]
    assert {r.call for r in recs} == {roots[0].call}
    children = defaultdict(int)
    for r in recs:
        assert 0 <= r.self_s <= r.host_s
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
            children[r.parent] += r.end_ns - r.start_ns
        assert not LAUNCH_NAMES & set(r.counters), r.counters  # the CPU runs the kernels' plain twins
        assert "h2d_bytes" not in r.counters  # nothing crosses to a device
    for r in recs:
        assert r.child_ns == children[r.id]
    flow = [r for r in recs if r.name == "flow.sample"]
    if flow or root in ("predict", "train_step"):
        assert len(flow) == 1
        assert sum(1 for r in recs if r.name == "flow.level" and r.parent == flow[0].id) == LEVELS


def test_summary_totals_the_records(traced):
    tracing.reset()
    with tracing.tracing():
        for fn in ("encoder", "heads"):
            with tracing.span("outer"), tracing.span(fn):
                tracing.count("h2d_bytes", 3)
    s = tracing.summary()
    assert s["outer"]["calls"] == 2 and s["encoder"]["calls"] == 1
    assert s["encoder"]["counters"] == {"h2d_bytes": 3} and s["outer"]["counters"] == {}
    recs = tracing.records()
    outer = [r for r in recs if r.name == "outer"]
    assert s["outer"]["host_s"] == pytest.approx(sum(r.host_s for r in outer))
    assert s["outer"]["self_s"] == pytest.approx(sum(r.self_s for r in outer))
    tracing.reset()


def test_spans_are_host_events_of_the_profiler(programs, small_hrnet_input):
    from torch.profiler import ProfilerActivity, profile

    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof, tracing.tracing():
        programs["predict"]()
    recs = tracing.records()
    tracing.reset()
    names = {r.name for r in recs}
    events = sorted((e for e in prof.events() if e.name in names), key=lambda e: e.time_range.start)
    assert Counter(e.name for e in events) == Counter(r.name for r in recs)
    # host operations, not annotations: the profiler draws an annotation again on the device's timeline
    assert not any(e.is_user_annotation for e in events)
    # the k-th record of a name is the k-th event of it; the events nest as the records do
    per_name = defaultdict(list)
    for e in events:
        per_name[e.name].append(e)
    event_of = {}
    for name in names:
        for r, e in zip(sorted((r for r in recs if r.name == name), key=lambda r: r.start_ns), per_name[name]):
            event_of[r.id] = e
    for r in recs:
        if r.parent is not None:
            e, p = event_of[r.id], event_of[r.parent]
            assert p.time_range.start <= e.time_range.start and e.time_range.end <= p.time_range.end, r.name


def test_a_profiler_without_tracing_sees_the_spans_and_nothing_is_recorded(programs):
    from torch.profiler import ProfilerActivity, profile

    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        programs["predict"]()
    got = Counter(e.name for e in prof.events() if e.name in PARENTS["predict"])
    assert got["predict"] == 1 and got["dist_infer"] == 1 and got["flow.level"] == LEVELS and got["smpl"] == 3
    assert tracing.records() == []


def test_the_ring_drops_the_oldest_and_the_totals_keep_all():
    tracing.reset()
    extra = 5
    with tracing.tracing():
        for _ in range(tracing.RING + extra):
            with tracing.span("x"):
                pass
    recs = tracing.records()
    assert len(recs) == tracing.RING
    assert recs[0].id == recs[-1].id - tracing.RING + 1
    assert tracing.summary()["x"]["calls"] == tracing.RING + extra
    tracing.reset()
    assert tracing.records() == [] and isinstance(tracing._records, deque)


def test_stage_timer_stages_are_spans():
    timer = StageTimer()
    tracing.reset()
    with tracing.tracing():
        timer.time_stage("add", lambda: torch.ones(4) + 1)
        with timer.stage("matmul", sync_result=[torch.ones(2, 2)]):
            pass
    s = tracing.summary()
    assert s["add"]["calls"] == 1 and s["matmul"]["calls"] == 1
    assert timer.summary()["add"]["count"] == 1
    tracing.reset()
