"""The fused tick block's contract, on the CPU.

`csrc/frame.cu` declares the state and parameter leaves it reads in two
X-macro tables; here they are parsed from the source and held against the
port's NamedTuples, so a leaf-order drift fails without a card. The
dispatch (`fused_ticks`) and its carry-across from the JAX package's
parameters are checked too. The kernel itself runs only on the card
(tests/test_torch_kernels.py, chip_smoke.py).
"""

import jax
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread)
from agrifly_tpu.sim import orchard_env as J
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.sim import cuda_frame
from agrifly_tpu_torch.sim import orchard_env as T

KW = dict(goal_world=(60.0, 0.0, 2.0), takeoff_height=2.0, start_flight_time=0.3,
          n_candidates=96, pyramid_capacity=16, width=160, height=120)
_WRITTEN_NEVER = {"planned", "plan_count", "frame_count", "waypoint_idx", "land_pos",
                  "land_start_step"}


def _table_rows(specs):
    return [(s.path, s.dtype, s.numel) for s in specs]


def _leaf_rows(pairs):
    return [(path, t.dtype, 0 if t.dim() == 0 else t.numel()) for path, t in pairs]


def test_state_leaf_table_matches_the_port():
    specs, _ = cuda_frame.leaf_table()
    state = T.init_state(T.make_params(**KW))
    assert _table_rows(specs) == _leaf_rows(convert.leaves(state))
    for s in specs:  # pass-through leaves are exactly those the ticks never write
        never = s.path[0] in _WRITTEN_NEVER or s.path[:2] == ("base", "gpsimu")
        assert s.written != never, s.path


def test_param_leaf_table_matches_the_port():
    _, specs = cuda_frame.leaf_table()
    p = T.make_params(**KW)
    want = [(("base",) + path, t) for path, t in convert.leaves(p.base)]
    want += [((name,), getattr(p, name))
             for name in ("start_flight_step", "takeoff_height", "track_lookahead")]
    assert _table_rows(specs) == _leaf_rows(want)
    assert [t.data_ptr() for t in cuda_frame.param_leaves(p)] == [t.data_ptr() for _, t in want]


def _noise(seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((16, 2, 3)).astype(np.float32))


def test_fused_dispatch_on_cpu_equals_plain():
    p = T.make_params(**KW)
    assert p.fused_ticks
    s = T.init_state(p)
    noise = _noise(3)
    before = T.frame_ticks_plain.calls
    got = T.frame_ticks(p, s, noise)
    ref = T.frame_ticks_plain(p._replace(fused_ticks=False), s, noise)
    assert T.frame_ticks_plain.calls == before + 2
    for (path, a), (_, b) in zip(convert.leaves(got), convert.leaves(ref)):
        assert torch.equal(a, b), path
    assert int(got.base.step) == 16


def test_wrapper_checks_leaves_against_the_table():
    p = T.make_params(**KW)
    s = T.init_state(p)
    bad = s._replace(base=s.base._replace(step=s.base.step.to(torch.int64)))
    with pytest.raises(ValueError, match="base.step"):
        cuda_frame.frame_ticks(p, bad, _noise(0))
    bad = s._replace(land_pos=torch.zeros(4))
    with pytest.raises(ValueError, match="land_pos"):
        cuda_frame.frame_ticks(p, bad, _noise(0))
    bad_p = p._replace(takeoff_height=p.takeoff_height[None])
    with pytest.raises(ValueError, match="takeoff_height"):
        cuda_frame.frame_ticks(bad_p, s, _noise(0))
    with pytest.raises(ValueError, match="noise"):
        cuda_frame.frame_ticks(p, s, _noise(0).double())


@pytest.mark.parametrize("fused", [None, True, False])
def test_fused_ticks_carries_across(fused):
    kw = {} if fused is None else {"fused_ticks": fused}
    jp = J.make_params(**KW, **kw)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    assert tp.fused_ticks is (fused is not False) is jp.fused_ticks
    assert T.make_params(**KW, **kw).fused_ticks is tp.fused_ticks
