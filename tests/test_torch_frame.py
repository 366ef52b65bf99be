"""The fused tick block's contract, and the port's entry points, on the CPU.

`csrc/frame.cu` declares the state and parameter leaves it reads in two
X-macro tables; here they are parsed from the source and held against the
port's NamedTuples, so a leaf-order drift fails without a card. The
dispatch (`fused_ticks`) and its carry-across from the JAX package's
parameters are checked too, and so is the wrapper's contract for a fleet
(a leading B on every state leaf, shared parameters). The kernel itself
runs only on the card (tests/test_torch_kernels.py, chip_smoke.py).

The port stands alone: no source of it imports jax or the JAX package (its
vehicle constants are its own copy, held here against the JAX package's),
and its entry point builds on the card unless the caller asks for the CPU.
"""

import ast
import dataclasses
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread)
from agrifly_tpu.models import constants as jconst
from agrifly_tpu.sim import orchard_env as J
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.models import constants as tconst
from agrifly_tpu_torch.sim import cuda_frame
from agrifly_tpu_torch.sim import orchard_env as T

ROOT = Path(__file__).resolve().parents[1]

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
    state = T.init_state(T.make_params(**KW, device="cpu"))
    assert _table_rows(specs) == _leaf_rows(convert.leaves(state))
    for s in specs:  # pass-through leaves are exactly those the ticks never write
        never = s.path[0] in _WRITTEN_NEVER or s.path[:2] == ("base", "gpsimu")
        assert s.written != never, s.path


def test_param_leaf_table_matches_the_port():
    _, specs = cuda_frame.leaf_table()
    p = T.make_params(**KW, device="cpu")
    want = [(("base",) + path, t) for path, t in convert.leaves(p.base)]
    want += [((name,), getattr(p, name))
             for name in ("start_flight_step", "takeoff_height", "track_lookahead")]
    assert _table_rows(specs) == _leaf_rows(want)
    assert [t.data_ptr() for t in cuda_frame.param_leaves(p)] == [t.data_ptr() for _, t in want]


def _noise(seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((16, 2, 3)).astype(np.float32))


def test_fused_dispatch_on_cpu_equals_plain():
    p = T.make_params(**KW, device="cpu")
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
    p = T.make_params(**KW, device="cpu")
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
    assert T.make_params(**KW, **kw, device="cpu").fused_ticks is tp.fused_ticks


SPAWNS = [[0.0, -3.0, 0.0], [0.0, 0.0, 0.0], [0.0, 3.0, 0.0], [1.0, 6.0, 0.5]]


def test_init_state_fleet_rows_equal_init_state():
    p = T.make_params(**KW, device="cpu")
    fleet = T.init_state_fleet(p, torch.tensor(SPAWNS))
    for b, pos in enumerate(SPAWNS):
        one = T.init_state(p, pos=tuple(pos))
        for (path, t), (_, r) in zip(convert.leaves(fleet), convert.leaves(one)):
            assert t.shape == (len(SPAWNS),) + r.shape, path
            assert torch.equal(t[b], r), (b, path)
    with pytest.raises(ValueError, match="positions"):
        T.init_state_fleet(p, torch.zeros(3))


def test_wrapper_takes_a_fleet_with_shared_params():
    p = T.make_params(**KW, device="cpu")
    s = T.init_state_fleet(p, torch.tensor(SPAWNS))
    state_specs, param_specs = cuda_frame.leaf_table()
    leaves, _ = convert.flatten_tensors(s)
    cuda_frame._check(state_specs, leaves, torch.device("cpu"), "state", len(SPAWNS))
    cuda_frame._check(param_specs, cuda_frame.param_leaves(p), torch.device("cpu"), "params")
    noise = torch.stack([_noise(b) for b in range(len(SPAWNS))])
    got = cuda_frame.frame_ticks(p, s, noise)  # CPU tensors: the plain fleet ticks
    for b in range(len(SPAWNS)):
        row = convert.flatten_tensors(s)[1]([t[b] for t in leaves])
        ref = T.frame_ticks_plain(p, row, noise[b])
        for (path, a), (_, r) in zip(convert.leaves(got), convert.leaves(ref)):
            assert torch.equal(a[b], r), (b, path)


def test_wrapper_raises_when_a_leaf_disagrees_with_the_noise_b():
    p = T.make_params(**KW, device="cpu")
    s = T.init_state_fleet(p, torch.tensor(SPAWNS))
    noise = torch.stack([_noise(b) for b in range(len(SPAWNS))])
    with pytest.raises(ValueError, match="leading 3"):
        cuda_frame.frame_ticks(p, s, noise[:3])
    bad = s._replace(land_pos=torch.zeros(len(SPAWNS) + 1, 3))
    with pytest.raises(ValueError, match="land_pos"):
        cuda_frame.frame_ticks(p, bad, noise)
    bad = s._replace(mstage=torch.zeros(len(SPAWNS), 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="mstage"):
        cuda_frame.frame_ticks(p, bad, noise)
    with pytest.raises(ValueError, match="plant.pos"):  # one vehicle's state, fleet noise
        cuda_frame.frame_ticks(p, T.init_state(p), noise)


@pytest.mark.parametrize("quad_type", [jconst.QC_TYPE_CF_STANDARD,
                                       jconst.QC_TYPE_CF_BIGMOTORSPROPS,
                                       jconst.QC_TYPE_CF_FEEDTHROUGH,
                                       jconst.QC_TYPE_CF_LARGEQUAD,
                                       jconst.QC_TYPE_CF_MINIQUAD])
def test_vehicle_constants_equal_the_jax_package(quad_type):
    mine, theirs = tconst.vehicle_params(quad_type), jconst.vehicle_params(quad_type)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    np.testing.assert_array_equal(mine.inertia_matrix, theirs.inertia_matrix)
    assert mine.prop_torque_from_speed_sqr == theirs.prop_torque_from_speed_sqr
    assert tconst.QC_TYPE_CF_MINIQUAD == jconst.QC_TYPE_CF_MINIQUAD
    # the module's public names are the JAX package's, and so are its maps
    public = lambda m: {n for n, v in vars(m).items()  # noqa: E731
                        if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    assert public(tconst) == public(jconst)
    assert tconst.TYPE_NAMES == jconst.TYPE_NAMES
    assert ([tconst.vehicle_type_from_id(i) for i in range(30)]
            == [jconst.vehicle_type_from_id(i) for i in range(30)])


def test_make_params_builds_on_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.make_params(**KW)
    p = T.make_params(**KW, device="cpu")
    assert {t.device.type for _, t in convert.leaves(p)} == {"cpu"}


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_import_nothing_of_the_jax_package():
    """Imports inside functions too (the kernels' lazy ones), which an
    import of the module does not run."""
    files = sorted((ROOT / "agrifly_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "agrifly_tpu"}
        assert not bad, (f.relative_to(ROOT), bad)
