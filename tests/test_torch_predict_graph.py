"""Distribution inference's CUDA-graph route (pipelines/predict.py) on the
CPU: which calls take it (CUDA, no mesh, K5's route), what its cache key
follows, and, with the capture
stood in by a CPU object that recomputes the body at each replay, that the
route's copies in and out give the eager body's outputs, keep callers'
outputs apart, recapture after an in-place weight write, drop the least
recently used shape and count its captures and replays on `dist_infer`.
The graph itself (capture, replay, K5's and K2's kernels inside a replay) is
held against the eager body on the card, tests/test_torch_kernels.py."""

import dataclasses

import numpy as np
import pytest
import torch

from humaniflow_torch.configs import get_humaniflow_cfg_defaults
from humaniflow_torch.flows import cuda_level
from humaniflow_torch.models import HumaniflowModel
from humaniflow_torch.models import smpl as tsmpl
from humaniflow_torch.pipelines import predict as tpredict
from humaniflow_torch.utils import tracing

IMG, B, N = 32, 2, 3


@pytest.fixture(scope="module")
def setup():
    cfg = get_humaniflow_cfg_defaults()
    cfg.DATA = dataclasses.replace(cfg.DATA, PROXY_REP_SIZE=IMG)
    model = HumaniflowModel(cfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(3))
    smpl = tsmpl.synthetic_smpl(num_verts=128, device="cpu")
    return cfg, model, smpl


def _inputs(model, b=B, n=N, seed=0):
    g = torch.Generator().manual_seed(seed)
    proxy = torch.rand((b, IMG, IMG, 18), generator=g)
    return proxy, model._draw_level_noise((b, n), g)


def _stand_in_capture(body, inputs):
    """`_capture` without CUDA: the same warm-up and static copies, and a
    'graph' whose replay recomputes the body on the static copies into the
    outputs it returned at the capture."""
    static = [t.clone() for t in inputs]
    first = body(*inputs)
    out = body(*static)

    class Graph:
        def replay(self):
            out.update(body(*static))

    return static, Graph(), out, first


@pytest.fixture
def forced(monkeypatch, setup):
    """The route forced on the CPU through the stand-in, with a fresh cache."""
    monkeypatch.setattr(tpredict, "_graph_route", lambda model, device, mesh: mesh is None)
    monkeypatch.setattr(tpredict, "_capture", _stand_in_capture)
    tpredict._GRAPHS.clear()
    yield setup
    tpredict._GRAPHS.clear()


def _eager(model, smpl, proxy, noise, n=N):
    with torch.inference_mode():
        return tpredict._predict_body(model, smpl, n, True, None, proxy, None, list(noise))


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("device,mesh,grad,refuse_k5,route", [
    ("cuda", None, False, False, True), ("cpu", None, False, False, False), ("cuda", "mesh", False, False, False),
    ("cuda", None, True, False, False), ("cuda", None, False, True, False),
])
def test_the_graph_route_is_cuda_with_no_mesh_on_the_fused_level(monkeypatch, setup, device, mesh, grad, refuse_k5,
                                                                 route):
    if refuse_k5:  # a flow K5 does not take: the eager flow, whose Permute a capture refuses
        monkeypatch.setattr(cuda_level, "supports_flow", lambda flow: False)
    with torch.set_grad_enabled(grad):
        assert tpredict._graph_route(setup[1], torch.device(device), mesh) is route


@pytest.mark.parametrize("grad", [False, True])
def test_off_the_card_every_call_runs_the_eager_body(monkeypatch, setup, grad):
    cfg, model, smpl = setup

    def refuse(*args):
        raise AssertionError("captured off the card")

    monkeypatch.setattr(tpredict, "_capture", refuse)
    proxy, noise = _inputs(model)
    with torch.set_grad_enabled(grad):
        got = tpredict.make_predict_fn(model, smpl, cfg, num_samples=N, device="cpu")(proxy, None, noise)
    _assert_equal(got, _eager(model, smpl, proxy, noise))


@pytest.mark.parametrize("change", ["in-place weight write", "moved parameter", "another B", "another N",
                                    "in-place encoder write"])
def test_the_cache_key_follows(setup, change):
    """The shape key follows B and N; the state key follows a moved tensor
    and K5's pack (load_state_dict writes the hypernet in place), and not a
    write in place outside the hypernet, which the graph reads where it
    lies."""
    cfg, model, smpl = setup
    model = HumaniflowModel(cfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(4))
    proxy, noise = _inputs(model)

    def keys(proxy, noise, n=N):
        return tpredict._shape_key(smpl, n, proxy, noise), tpredict._state_key(model, smpl)

    before = keys(proxy, noise)
    assert keys(proxy, noise) == before
    if change == "in-place weight write":
        model.load_state_dict(HumaniflowModel(cfg.MODEL, device="cpu").state_dict())
        after = keys(proxy, noise)
    elif change == "moved parameter":
        model.fc1.weight.data = model.fc1.weight.data.clone()
        after = keys(proxy, noise)
    elif change == "in-place encoder write":
        with torch.no_grad():
            next(model.encoder.parameters()).mul_(2.0)
        after = keys(proxy, noise)
    elif change == "another B":
        after = keys(*_inputs(model, b=B + 1))
    else:
        after = keys(*_inputs(model, n=N + 1), n=N + 1)
    moved = [a != b for a, b in zip(after, before)]
    want = {"in-place weight write": [False, True], "moved parameter": [False, True],
            "in-place encoder write": [False, False]}.get(change, [True, False])
    assert moved == want


@pytest.mark.parametrize("noise_from", ["explicit noise", "a generator"])
def test_replays_give_the_eager_body_and_leave_earlier_outputs_alone(forced, noise_from):
    cfg, model, smpl = forced
    predict = tpredict.make_predict_fn(model, smpl, cfg, num_samples=N, device="cpu")
    calls = []
    for seed in (0, 1, 2):
        proxy, noise = _inputs(model, seed=seed)
        if noise_from == "explicit noise":
            got = predict(proxy, None, noise)
        else:
            got = predict(proxy, torch.Generator().manual_seed(seed))
            noise = model._draw_level_noise((B, N), torch.Generator().manual_seed(seed))
        calls.append((got, {k: v.clone() for k, v in got.items()}, _eager(model, smpl, proxy, noise)))
    assert len(tpredict._GRAPHS[model]) == 1
    for got, copy, want in calls:
        _assert_equal(got, want)
        _assert_equal(got, copy)  # no later call wrote into it
    assert not torch.equal(calls[1][0]["verts_samples"], calls[2][0]["verts_samples"])


def test_an_in_place_weight_write_forces_a_new_capture(forced):
    cfg, model, smpl = forced
    model = HumaniflowModel(cfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(5))
    predict = tpredict.make_predict_fn(model, smpl, cfg, num_samples=N, device="cpu")
    proxy, noise = _inputs(model)
    tracing.reset()
    with tracing.tracing():
        first = predict(proxy, None, noise)
        model.load_state_dict(HumaniflowModel(cfg.MODEL, device="cpu").state_dict())
        second = predict(proxy, None, noise)
    assert tracing.summary()["dist_infer"]["counters"] == {"graph_captures": 2}
    _assert_equal(second, _eager(model, smpl, proxy, noise))
    assert not torch.equal(first["verts_samples"], second["verts_samples"])
    assert len(tpredict._GRAPHS[model]) == 1  # the stale graph went


def test_an_in_place_write_outside_the_hypernet_replays(forced):
    """The encoder's weights written in place between two calls: the second
    call replays (the graph reads them where they lie) and gives the eager
    body under the new weights."""
    cfg, model, smpl = forced
    model = HumaniflowModel(cfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(6))
    predict = tpredict.make_predict_fn(model, smpl, cfg, num_samples=N, device="cpu")
    proxy, noise = _inputs(model)
    tracing.reset()
    with tracing.tracing():
        first = predict(proxy, None, noise)
        with torch.no_grad():
            for p in model.encoder.parameters():
                p.mul_(1.5)
        second = predict(proxy, None, noise)
    assert tracing.summary()["dist_infer"]["counters"] == {"graph_captures": 1, "graph_replays": 1}
    _assert_equal(second, _eager(model, smpl, proxy, noise))
    assert not torch.equal(first["input_feats"], second["input_feats"])


def test_the_least_recently_used_shape_goes_first(forced):
    cfg, model, smpl = forced
    predict = tpredict.make_predict_fn(model, smpl, cfg, num_samples=N, device="cpu")
    call = lambda b: predict(_inputs(model, b=b)[0], None, _inputs(model, b=b)[1])  # noqa: E731
    sizes = range(1, tpredict.GRAPHS_PER_MODEL + 2)
    for b in sizes:
        call(b)
        if b == 2:
            call(1)  # B = 1 used again
    kept = sorted(key[2][0][0] for key in tpredict._GRAPHS[model])
    assert kept == [b for b in sizes if b != 2]


def test_captures_and_replays_are_counters_of_dist_infer(forced):
    cfg, model, smpl = forced
    rng = np.random.default_rng(4)
    images = rng.uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    j2d = rng.uniform(0, IMG, size=(B, 17, 2)).astype(np.float32)
    tracing.reset()
    with tracing.tracing():
        preds = [tpredict.predict_humaniflow(model, smpl, cfg, images, j2d, num_samples=N, device="cpu")
                 for _ in range(3)]
    summary = tracing.summary()
    assert summary["dist_infer"]["calls"] == 3
    assert summary["dist_infer"]["counters"] == {"graph_captures": 1, "graph_replays": 2}
    for pred in preds[1:]:
        _assert_equal(pred, preds[0])  # the default generator, seeded 0 at each call
