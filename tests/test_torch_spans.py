"""The port's profiler ranges inside a served request and a train step, on
the CPU.

``InferenceServer.predict`` runs inside one ``serve.predict`` range and,
for each top-bucket chunk in turn, ``serve.stage``, ``serve.guard``,
``serve.forward`` (``serve.replay`` on the card) and ``serve.readback``,
one after another inside it. ``make_train_step``'s step runs inside one
``train_step`` range that its four phases (prepare, forward, backward,
optimizer) divide up. With the profiler on, the answers, the loss and
the updated weights equal those with it off, bit for bit. (The slice
configuration of ``test_torch_serve.py``, S=4, 32 px; the light one of
``test_torch_train.py`` for the step.)
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from jmt_tpu_torch.core.config import Config, ModelParams, OptimParams
from jmt_tpu_torch.models.common import init_parameters
from jmt_tpu_torch.models.jmt_model import JMTModel
from jmt_tpu_torch.serve import InferenceServer
from jmt_tpu_torch.train import loops

torch.set_num_threads(2)

CFG = dict(vision_backbones=("R2D1",), audio_backbones=("ResNet18", "wavLM"),
           intra_modal_fusion="encoder_plus_self_attention")
TRAIN_CFG = dict(vision_backbones=("R2D1",), audio_backbones=("ResNet18",))
OPT = dict(lr=1e-2, momentum=0.9, nesterov=True, weight_decay=1e-4)
B, S, PX = 2, 4, 32
PHASES = ("serve.stage", "serve.guard", "serve.forward", "serve.readback")
STEP_PHASES = tuple(f"train_step.{p}" for p in
                    ("prepare", "forward", "backward", "optimizer"))


def _request(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, S, 8, PX, PX, 3), dtype=np.uint8),
            (0.1 * rng.normal(size=(n, S, 45599))).astype(np.float32),
            rng.normal(size=(n, S, 768)).astype(np.float32))


@pytest.fixture(scope="module")
def server():
    model = init_parameters(JMTModel(**CFG), torch.Generator().manual_seed(0))
    return InferenceServer(model, seq=S, buckets=(2, 4), img_size=PX,
                           device="cpu")


def _ranges(fn, prefix):
    """fn()'s result and its host ranges named ``prefix*`` as (start_ns,
    end_ns, name), in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    got = sorted((ev.start_ns(), ev.end_ns(), ev.name())
                 for ev in prof.profiler.kineto_results.events()
                 if ev.name().startswith(prefix))
    return out, got


def _in_order(outer, inner, names):
    """``inner`` lies inside ``outer``, one range after another, with the
    given names in that order."""
    assert [n for _, _, n in inner] == list(names)
    assert all(outer[0] <= s <= e <= outer[1] for s, e, _ in inner)
    assert all(e0 <= s1 for (_, e0, _), (s1, _, _) in zip(inner, inner[1:]))


def test_one_request_runs_inside_one_predict_range(server):
    _, got = _ranges(lambda: server.predict(*_request(3)), "serve.")
    outer = [r for r in got if r[2] == "serve.predict"]
    assert len(outer) == 1
    _in_order(outer[0], [r for r in got if r[2] != "serve.predict"], PHASES)


def test_a_split_request_nests_each_chunk_in_one_predict_range(server):
    """5 rows over a top bucket of 4: chunks of 4 and 1, each with its own
    stage, guard, forward and readback inside the one request's range."""
    _, got = _ranges(lambda: server.predict(*_request(5)), "serve.")
    outer = [r for r in got if r[2] == "serve.predict"]
    assert len(outer) == 1
    _in_order(outer[0], [r for r in got if r[2] != "serve.predict"],
              PHASES * 2)


@pytest.mark.parametrize("n", [3, 5])
def test_answers_are_the_same_with_the_profiler_on(server, n):
    req = _request(n, seed=n)
    off = server.predict(*req)
    on, got = _ranges(lambda: server.predict(*req), "serve.")
    assert got
    for x, y in zip(off, on):
        assert x.shape == (n, S) and np.isfinite(x).all()
        assert np.array_equal(x, y)


def _train_step(seed=0):
    """A fresh light model's state and step, and a batch."""
    mp = dict(l_vision_backbones=list(TRAIN_CFG["vision_backbones"]),
              l_audio_backbones=list(TRAIN_CFG["audio_backbones"]),
              intra_modal_fusion="None")
    cfg = Config(model_params=ModelParams(**mp, opt=OptimParams(**OPT)))
    model = JMTModel(**TRAIN_CFG)
    state = loops.init_state(model, cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    rng = np.random.default_rng(seed)
    clips, audio, _ = _request(B, seed)
    arrays = {"clips": clips, "audio": audio,
              "labels_v": rng.uniform(-1, 1, (B, S)).astype(np.float32),
              "labels_a": rng.uniform(-1, 1, (B, S)).astype(np.float32)}
    step = loops.make_train_step(model, device="cpu")

    def one():
        return step(state, arrays, torch.Generator().manual_seed(1))
    return model, one


def test_train_step_phases_divide_the_step():
    _, one = _train_step()
    one()
    _, got = _ranges(one, "train_step")
    outer = [r for r in got if r[2] == "train_step"]
    assert len(outer) == 1
    phases = [r for r in got if r[2] != "train_step"]
    _in_order(outer[0], phases, STEP_PHASES)
    covered = sum(e - s for s, e, _ in phases)
    assert covered >= 0.95 * (outer[0][1] - outer[0][0])


def test_train_step_is_the_same_with_the_profiler_on():
    results = []
    for profiled in (False, True):
        model, one = _train_step()
        before = {k: t.clone() for k, t in model.state_dict().items()}
        if profiled:
            (loss, v, a), got = _ranges(one, "train_step")
            assert got
        else:
            loss, v, a = one()
        after = {k: t.detach().clone() for k, t in model.state_dict().items()}
        assert any(not torch.equal(before[k], after[k]) for k in after)
        results.append((loss, v, a, after))
    off, on = results
    assert torch.isfinite(off[0])
    for x, y in zip(off[:3], on[:3]):
        assert torch.equal(x, y)
    assert off[3].keys() == on[3].keys()
    assert all(torch.equal(off[3][k], on[3][k]) for k in off[3])
