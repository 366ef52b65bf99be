"""Helpers for the PyTorch port's parity tests against the JAX package.

Both packages get the same inputs, made with numpy from a seed; randomness
the JAX package draws from its PRNG key is drawn there and injected into the
port. JAX runs on the CPU (tests/conftest.py) with x64 enabled, so inputs
are explicit float32/int32 arrays.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from agrifly_tpu_torch import convert

# The suite runs several pytest workers on one machine beside wall-clock-paced
# tests (tests/test_realtime.py). The port's tensors here are small, so torch's
# intra-op thread pool would only compete with them for cores.
torch.set_num_threads(1)

# Float leaves: elementwise |d| <= FLOAT_REL * (|ref| + FLOAT_FLOOR), the
# criterion of the JAX package's frame-parity artifact (VERIFY_r05_frame.json).
FLOAT_REL = 1e-3
FLOAT_FLOOR = 1e-3

# The commanded body rates carry the attitude controller's acos of a cosine
# within a few ulps of 1 (attitude errors of ~1e-3 rad): one ulp of input
# moves the angle by percent, times the 25 /s gain. The JAX package records
# a ~1e-2 rad/s intrinsic command agreement floor against the C++ reference
# for the same reason. Leaves that hold those commands, and the
# wire codes that quantize them (35/32768 per code), are held to that floor.
COMMAND_FLOOR = 1e-2
COMMAND_LEAVES = {("base", "last_cmd_angvel"), ("base", "mocap", "pipe", "angvel")}
WIRE_LEAVES = {("base", "ring", "fields")}
WIRE_MAX_CODES = int(np.ceil(COMMAND_FLOOR / (35.0 / 32768.0)))


def jax_leaf(tree, path):
    for name in path:
        tree = getattr(tree, name)
    return np.asarray(tree)


def compare_state(port_state, jax_state):
    """Hold every leaf of a port state against the JAX state's leaf of the
    same name. Returns the worst (ratio, path) float leaves; asserts."""
    failures, worst = [], []
    for path, t in convert.leaves(port_state):
        ref = jax_leaf(jax_state, path)
        got = t.cpu().numpy()
        assert got.shape == ref.shape, (path, got.shape, ref.shape)
        if path in WIRE_LEAVES:
            d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
            if d.max(initial=0) > WIRE_MAX_CODES:
                failures.append((path, int(d.max())))
        elif ref.dtype.kind in "biu":
            if not np.array_equal(got, ref):
                failures.append((path, "discrete leaf differs"))
        else:
            d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
            if path in COMMAND_LEAVES:
                bound = COMMAND_FLOOR + FLOAT_REL * np.abs(ref)
            else:
                bound = FLOAT_REL * (np.abs(ref) + FLOAT_FLOOR)
            ratio = float((d / bound).max(initial=0.0))
            worst.append((ratio, path))
            if ratio > 1.0:
                failures.append((path, ratio))
    worst.sort(reverse=True)
    assert not failures, (failures, worst[:5])
    return worst[:5]


def make_scene(W, H, n_obstacles, seed):
    """Random box obstacles on a far background (int32 depth codes): the
    scene of tests/test_pallas_inflate.py, in numpy."""
    rng = np.random.default_rng(seed)
    img = np.full((H, W), 230, np.int32)
    for _ in range(n_obstacles):
        x = rng.integers(5, W - 5)
        y = rng.integers(5, H - 5)
        w = rng.integers(3, max(4, W // 8))
        h = rng.integers(5, max(6, H // 2))
        d = rng.integers(25, 140)
        img[max(0, y - h // 2):y + h // 2, max(0, x - w // 2):x + w // 2] = d
    return img


def gradient_scene(W, H):
    """Sparse, blocker-free far background: a depth gradient with no pixel
    nearer than any pyramid's required depth (the case in which a wrong
    base-depth tile skip shows)."""
    ys, xs = np.mgrid[0:H, 0:W]
    return (20000 + 3 * xs + 7 * ys).astype(np.int32)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")
