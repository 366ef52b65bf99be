"""The port's OrchardBridge block paths on the CPU, at 32x24 with 8
candidates: the pipelined loop (block k queued before block k-1 publishes)
against the synced one, and the image topics against the frame's own render.

`fly_frames_pipelined` reorders device work only, never the topic surface,
so its bag, images included, is byte-equal to the synced loop's. Each
published depth image is the millimetre image of the depth codes the
planner took in its frame (recorded from the render wrapper the frame
calls), through the throttle and downsample knobs.
"""

import inspect

import numpy as np
import pytest
import torch

from _torch_parity import COMMAND_FLOOR  # noqa: F401 (one torch thread)
from agrifly_tpu_torch.io import bridge as tbridge
from agrifly_tpu_torch.render import cuda_raycast
from agrifly_tpu_torch.sim import orchard_env as T

KW = dict(width=32, height=24, n_candidates=8)


@pytest.fixture(scope="module")
def params():
    return T.make_params(device="cpu", **KW)


@pytest.fixture
def planner_inputs(monkeypatch):
    """The depth codes each frame's _frame_percept rendered, in frame order
    (the render wrapper's other calls are the bridge's image renders)."""
    seen = []
    render = cuda_raycast.render_depth_batch

    def recording(cfg, scene, pos, cam_att):
        out = render(cfg, scene, pos, cam_att)
        if any(f.function == "_frame_percept" for f in inspect.stack()[1:4]):
            seen.append(out[0].clone())
        return out

    monkeypatch.setattr(cuda_raycast, "render_depth_batch", recording)
    return seen


def test_fly_frames_pipelined_matches_synced(params, planner_inputs, tmp_path):
    """22 frames in blocks of 8, synced and pipelined, images on (every 4th
    frame, every 2nd row and column) and recorded: the two bags are
    byte-equal, the remainder block is flown and on_block sees 8, 16, 22
    frames; each published depth image is the planner's input of its frame,
    bit for bit, in millimetres; RGB and the handshake flag come with it."""
    bags = {}
    images = {}
    for fly in ("synced", "pipelined"):
        planner_inputs.clear()
        ob = tbridge.OrchardBridge(params, vehicle_id=1, seed=3, image_throttle=4,
                                   image_downsample=2)
        depth = []
        ob.bus.subscribe("depthImage1", depth.append)
        bags[fly] = tmp_path / f"{fly}.jsonl"
        rec = tbridge.MessageRecorder(ob.bus, str(bags[fly]), record_images=True)
        if fly == "synced":
            done = 0
            while done < 22:
                b = min(8, 22 - done)
                ob.fly_frames_block(b)
                done += b
        else:
            blocks = []
            assert ob.fly_frames_pipelined(22, 8, lambda outs, d: blocks.append(d)) == 22
            assert blocks == [8, 16, 22]
        rec.close()
        assert ob.frame_count == 22
        assert len(planner_inputs) == 22
        images[fly] = (depth, [c.numpy() for c in planner_inputs])
        counts = dict(ob.bus.counts)
        assert counts["depthImage1"] == counts["rgbImage1"] == counts["imageReceivedFlag1"] == 6
    assert bags["synced"].read_bytes() == bags["pipelined"].read_bytes()
    depth, inputs = images["pipelined"]
    scale = float(params.planner.cam.depth_scale)
    for m in depth:
        seq = m.header.seq
        assert seq % 4 == 0 and (m.height, m.width, m.step) == (12, 16, 32)
        want = tbridge.depth_to_mm16(inputs[seq], scale)[::2, ::2]
        assert np.array_equal(np.frombuffer(m.data, "<u2").reshape(12, 16), want), seq
    assert [m.header.seq for m in depth] == [0, 4, 8, 12, 16, 20]


def test_image_knobs(params):
    """publish_rgb=False publishes no rgbImage; image_throttle=3 publishes
    frames 0 and 3 of 4 at full size; publish_images=False none at all."""
    ob = tbridge.OrchardBridge(params, vehicle_id=2, seed=1, publish_rgb=False, image_throttle=3)
    got = []
    ob.bus.subscribe("depthImage2", got.append)
    ob.fly_frames(4, block=2)
    assert ob.bus.counts["depthImage2"] == ob.bus.counts["imageReceivedFlag2"] == 2
    assert ob.bus.counts.get("rgbImage2", 0) == 0
    assert [(m.header.seq, m.height, m.width) for m in got] == [(0, 24, 32), (3, 24, 32)]
    quiet = tbridge.OrchardBridge(params, vehicle_id=2, publish_images=False)
    quiet.frame()
    assert not any("Image" in t or "imageReceived" in t for t in quiet.bus.counts)
    assert torch.equal(quiet.state.frame_count, torch.tensor(1, dtype=torch.int32))
