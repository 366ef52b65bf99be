"""The percept head (K9) and the planner's round kernels (K10-K12) against
their plain PyTorch versions, on the card.

These tests import no JAX, so they run on a machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rounds_kernels.py

Without a card they skip, but for the check that the wrappers' constants
are the kernel sources'. On the orchard frame at its default (640x480, 256
candidates, capacity 32, 2 + 1 rounds, 2x2 pooling), one vehicle and a
fleet of 16: the head bit for bit, and each round kernel bit for bit on
the plain chain's inputs and on chip_smoke's adversarial cases (tied, -0.0,
NaN and +inf costs; no gated candidate; a full set; fail points on and
beyond the image's edges); a 20-frame flight through the kernels equals
the same flight through the plain versions on the card.
"""

import re

import pytest
import torch

from _torch_parity import cuda  # noqa: F401
from agrifly_tpu_torch import cuda_build
from agrifly_tpu_torch.planner import cuda_rounds, rappids
from agrifly_tpu_torch.render import cuda_raycast
from agrifly_tpu_torch.sim import cuda_percept, orchard_env
from chip_smoke import _adversarial_rounds, _leaves_equal, lanes, round_chain

FRAMES = 20


def test_wrapper_constants_match_the_kernel_sources():
    rounds = (cuda_build.CSRC / "rounds.cu").read_text()
    assert int(re.search(r"kMaxConsidered = (\d+);", rounds).group(1)) == \
        cuda_rounds.MAX_LAZY_CONSIDERED
    frame = (cuda_build.CSRC / "frame.cu").read_text()
    offsets = dict(re.findall(r"kH(\w+) = (\d+)", frame))
    at = 0
    for name, n in cuda_percept.HEAD_FIELDS:
        key = "".join(w.capitalize() for w in name.split("_"))
        assert int(offsets[key]) == at, name
        at += n
    assert "of 29" in frame and at == 29


def _step(p, s, gen):
    return (orchard_env.frame_step if s.base.step.dim() == 0 else orchard_env.frame_step_fleet)(
        p, s, gen)


def _flown(dev, B, frames=80):
    """A state `frames` frames into a flight whose planning starts at frame
    32 (one vehicle, or B in lanes)."""
    p = orchard_env.make_params(start_flight_time=1.0, device=dev)
    s = orchard_env.init_state(p) if B is None else orchard_env.init_state_fleet(p, lanes(B, dev))
    gen = torch.Generator(device=dev).manual_seed(1)  # chip_smoke's 80-frame flight
    for _ in range(frames):
        s, _ = _step(p, s, gen)
    return p, s, gen


def _assert_equal(name, got, ref):
    assert _leaves_equal(tuple(got) if isinstance(got, tuple) else got,
                         tuple(ref) if isinstance(ref, tuple) else ref), name


@pytest.mark.cuda
@pytest.mark.parametrize("B", [None, 16], ids=["B=1", "B=16"])
def test_percept_head_kernel_bit_equal_to_plain(cuda, B):  # noqa: F811
    p, s, gen = _flown(cuda, B)
    for _ in range(3):
        lead = s.base.step.shape
        u = torch.rand(lead + (4, p.n_candidates), generator=gen, device=cuda)
        before = cuda_percept.percept_head.launches
        _assert_equal("K9", cuda_percept.percept_head(p, s, u),
                      orchard_env.percept_head_plain(p, s, u))
        assert cuda_percept.percept_head.launches == before + 1
        s, _ = _step(p, s, gen)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [None, 16], ids=["B=1", "B=16"])
def test_round_kernels_bit_equal_to_plain(cuda, B):  # noqa: F811
    p, s, gen = _flown(cuda, B)
    lead = s.base.step.shape
    u = torch.rand(lead + (4, p.n_candidates), generator=gen, device=cuda)
    head = orchard_env.percept_head_plain(p, s, u)
    depth = cuda_raycast.render_depth_batch(
        p.render_cfg, p.scene, s.base.plant.pos.reshape(-1, 3), head.cam_att.reshape(-1, 4)
    ).reshape(lead + (p.render_cfg.height, p.render_cfg.width))
    held = []

    def check(name, ref, kernel):
        _assert_equal(name, kernel(), ref)
        held.append(name)

    args = (p.planner, depth, head.candidates, head.grav_cam, p.pyramid_capacity,
            p.planner_rounds, p.inflation_downsample)
    _, info = round_chain(*args, check=check)
    _adversarial_rounds(*args, check, cuda)
    assert len(held) >= 15 and int(info["pyrs"].valid.sum()) > 0 and int(info["failed"].sum()) > 0


@pytest.mark.cuda
def test_flight_through_the_kernels_equals_the_plain_path(cuda, monkeypatch):  # noqa: F811
    """FRAMES frames from the start of planning, through K9-K12 and through
    their plain versions on the card (the same draws): outputs and final
    state bit for bit."""
    p, s0, _ = _flown(cuda, None, frames=30)
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(cuda_percept, "percept_head", orchard_env.percept_head_plain)
            monkeypatch.setattr(cuda_rounds, "round_seeds", rappids.round_seeds_plain)
            monkeypatch.setattr(cuda_rounds, "pyramid_set", rappids.pyramid_set_plain)
            monkeypatch.setattr(cuda_rounds, "lazy_seeds", rappids.lazy_seeds_plain)
        gen = torch.Generator(device=cuda).manual_seed(11)
        runs.append(orchard_env.fly(p, s0, FRAMES, gen))
    (s_k, out_k), (s_p, out_p) = runs
    assert _leaves_equal(s_k, s_p)
    assert out_k.keys() == out_p.keys() and all(torch.equal(out_k[k], out_p[k]) for k in out_k)
    assert int(s_k.plan_count) > int(s0.plan_count)


@pytest.mark.cuda
def test_round_kernels_refuse_what_they_do_not_take(cuda):  # noqa: F811
    p, s, gen = _flown(cuda, None, frames=1)
    u = torch.rand((4, p.n_candidates), generator=gen, device=cuda)
    head = orchard_env.percept_head_plain(p, s, u)
    c = head.candidates
    work = rappids.work_image(p.planner, torch.zeros((480, 640), dtype=torch.int32, device=cuda),
                              2)
    gate = torch.ones(c.cost.shape, dtype=torch.bool, device=cuda)
    before = cuda_rounds.round_seeds.launches
    with pytest.raises(ValueError, match="cost"):
        cuda_rounds.round_seeds(work, gate, c.cost.double(), c.epx, c.epy, c.endz, None, 0, 10)
    with pytest.raises(ValueError, match="gate"):
        cuda_rounds.round_seeds(work, gate.int(), c.cost, c.epx, c.epy, c.endz, None, 0, 10)
    assert cuda_rounds.round_seeds.launches == before
    with pytest.raises(ValueError, match="u"):
        cuda_percept.percept_head(p, s, u[None])
    with pytest.raises(ValueError, match="img"):  # the pooled image where the full one goes
        cuda_rounds.lazy_seeds(p.planner, work, work.img, gate, gate, c.epx, c.epy, c.endz,
                               c.cost, rappids.empty_pyramid_set(22, cuda), 10)
