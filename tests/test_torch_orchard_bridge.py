"""The port's OrchardBridge (`agrifly_tpu_torch/io/bridge.py`) against the
JAX package's, on the CPU, at 32x24 with 8 candidates.

Both bridges fly from the same state on the same draws: the JAX bridge
splits its state's key each frame, and the port's takes those draws through
its `draws` hook (`_torch_parity.jax_frame_draws`). The JAX bridge runs the
plain paths (`use_pallas=False, fused_ticks=False`), and compiles one
fly_diag block size only. The bags are compared line by line
(`_torch_parity.bag_bound`: topics, order, stamps and integers equal; floats
to the tick criteria over the first 60 ticks, then the long-rollout terms;
the commanded body rates within the command floor, the command stream's
wire codes within the floor's codes and telemetry within one wire code
throughout). The image topics are held
against the JAX package's renderers, and the bridge's host helpers against
the JAX package's on the same host rows.
"""

import base64
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bag_bound, compare_bags, jax_frame_draws, read_bag
from agrifly_tpu.io import bridge as jbridge
from agrifly_tpu.io import messages as jmsgs
from agrifly_tpu.io import radio as jradio
from agrifly_tpu.models import logic as jlogic
from agrifly_tpu.render import raycast as jray
from agrifly_tpu.sim import orchard_env as J
from agrifly_tpu_torch import convert
from agrifly_tpu_torch.io import bridge as tbridge
from agrifly_tpu_torch.io import messages as tmsgs
from agrifly_tpu_torch.io import radio as tradio
from agrifly_tpu_torch.models import logic as tlogic
from agrifly_tpu_torch.sim import orchard_env as T

KW = dict(width=32, height=24, n_candidates=8)
N_BEFORE, N_AFTER = 8, 2  # frames before and after the external kill
JAX_BLOCK = 2  # every JAX block flies this many frames: one compiled program


def _jax_params():
    return J.make_params(use_pallas=False, fused_ticks=False, **KW)


def _port_params(jp):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _draws_from(u, noise):
    """A bridge `draws` hook serving the frames of (u, noise) in order."""
    at = [0]

    def draws(n):
        i = at[0]
        assert i + n <= len(u), "the test drew too few JAX draws"
        at[0] += n
        return torch.from_numpy(u[i:i + n].copy()), torch.from_numpy(noise[i:i + n].copy())
    return draws


def _kill(bus, msgs_mod, radio_mod):
    raw = radio_mod.fields_to_bytes(*radio_mod.make_kill_command())
    bus.publish("radio_command1", msgs_mod.RadioCommand(raw=raw))


def _decoded_commands(bag):
    """The bag with each radio_command's raw bytes as (type, flags) and its
    ten field codes (floats, held to the command floor's codes)."""
    for line in bag:
        if line["topic"].startswith("radio_command"):
            mtype, flags, fields = tradio.bytes_to_fields(base64.b64decode(line["msg"]["raw"]))
            line["msg"]["raw"] = {"type": mtype, "flags": flags,
                                  "codes": [float(c) for c in fields]}
    return bag


def test_orchard_bridge_bag_matches_jax(tmp_path):
    """8 frames in one block, an external kill on radio_command1, 2 more
    frames (the JAX bridge flies the same frames in blocks of 2): the bags
    agree message for message; the bridge's own 50 Hz command stream never
    enters the delay line (echo guard), the external kill does, and both
    vehicles end the flight killed."""
    jp = _jax_params()
    jb = jbridge.OrchardBridge(jp, vehicle_id=1, seed=0, publish_images=False)
    u, noise, _ = jax_frame_draws(jb.state.base.key, N_BEFORE + N_AFTER, KW["n_candidates"])
    tb = tbridge.OrchardBridge(_port_params(jp), vehicle_id=1, publish_images=False,
                               draws=_draws_from(u, noise))
    bags = {"theirs": tmp_path / "theirs.jsonl", "mine": tmp_path / "mine.jsonl"}
    jrec = jbridge.MessageRecorder(jb.bus, str(bags["theirs"]))
    for _ in range(N_BEFORE // JAX_BLOCK):
        jb.fly_frames_block(JAX_BLOCK)
    _kill(jb.bus, jmsgs, jradio)
    jb.fly_frames_block(JAX_BLOCK)
    jrec.close()

    trec = tbridge.MessageRecorder(tb.bus, str(bags["mine"]))
    tb.fly_frames_block(N_BEFORE)
    assert tb.bus.counts["radio_command1"] > 0 and len(tb._pending_radio) == 0  # echo guard
    _kill(tb.bus, tmsgs, tradio)
    assert len(tb._pending_radio) == 1
    tb.fly_frames_block(N_AFTER)
    trec.close()

    mine = _decoded_commands(read_bag(bags["mine"]))
    theirs = _decoded_commands(read_bag(bags["theirs"]))
    worst = compare_bags(mine, theirs, bag_bound)
    print(f"{len(mine)} messages; worst float {worst:.4g} x its bound")
    assert dict(tb.bus.counts) == dict(jb.bus.counts)
    assert tb.frame_count == jb.frame_count == N_BEFORE + N_AFTER
    assert int(tb.last_outs["flight_state"][-1]) == int(jb.last_outs["flight_state"][-1]) \
        == tlogic.FS_KILLED == jlogic.FS_KILLED
    assert tb.wire_counts == jb.wire_counts


def test_image_topics_match_the_jax_renderers():
    """Two frames with the image topics: each depthImage is the mm16 of the
    JAX renderer's codes at the frame's pre-frame pose, and each rgbImage is
    within one code of the JAX RGB render (the held rules of
    tests/test_torch_render.py and test_torch_rgb.py: at most 0.05% of
    pixels one depth code apart, or more than one RGB code apart); the
    handshake flag follows each image pair with the same stamp and seq."""
    jp = _jax_params()
    tb = tbridge.OrchardBridge(_port_params(jp), vehicle_id=1, seed=2)
    got = []
    for topic in ("depthImage1", "rgbImage1", "imageReceivedFlag1", "simulator_truth1"):
        tb.bus.subscribe(topic, lambda m, topic=topic: got.append((topic, m)))
    pose0 = (tb.state.base.plant.pos.numpy().copy(), tb.state.base.plant.att.numpy().copy())
    tb.fly_frames_block(2)
    assert [t for t, _ in got] == (["depthImage1", "rgbImage1", "imageReceivedFlag1"] * 2
                                   + ["simulator_truth1"] * 2)
    truths = [m for t, m in got if t == "simulator_truth1"]
    poses = [pose0, (np.array([truths[0].posx, truths[0].posy, truths[0].posz], np.float32),
                     np.array([truths[0].attq0, truths[0].attq1, truths[0].attq2,
                               truths[0].attq3], np.float32))]
    depth = [m for t, m in got if t == "depthImage1"]
    rgb = [m for t, m in got if t == "rgbImage1"]
    flags = [m for t, m in got if t == "imageReceivedFlag1"]
    render_d = jax.jit(lambda p, a: jray.render_depth(jp.render_cfg, jp.scene, p,
                                                      jray.camera_attitude(a)))
    render_c = jax.jit(lambda p, a: jray.render_rgb(jp.render_cfg, jp.scene, p,
                                                    jray.camera_attitude(a)))
    off_by_one = far_off = 0
    for i, (pos, att) in enumerate(poses):
        d = depth[i]
        assert (d.encoding, d.height, d.width, d.step, d.header.seq) == ("16UC1", 24, 32, 64, i)
        mm = np.frombuffer(d.data, "<u2").reshape(24, 32)
        codes = np.asarray(render_d(jnp.asarray(pos), jnp.asarray(att)))
        ref = jbridge.depth_to_mm16(codes, float(jp.planner.cam.depth_scale))
        step_mm = float(jp.planner.cam.depth_scale) * 1000.0
        diff = np.abs(mm.astype(np.int64) - ref.astype(np.int64))
        assert diff.max() <= np.ceil(step_mm)
        off_by_one += int((diff > 0).sum())
        c = rgb[i]
        assert (c.encoding, c.height, c.width, c.step) == ("rgb8", 24, 32, 96)
        img = np.frombuffer(c.data, np.uint8).reshape(24, 32, 3)
        ref_c = np.asarray(render_c(jnp.asarray(pos), jnp.asarray(att)))
        far_off += int((np.abs(img.astype(np.int64) - ref_c.astype(np.int64)) > 1)
                       .any(-1).sum())
        assert (flags[i].stamp, flags[i].seq) == (d.header.stamp, i) == (c.header.stamp, i)
        assert d.header.stamp == pytest.approx(i * 16 * 0.002)
    print(f"depth pixels one code apart: {off_by_one}; RGB pixels more than one code "
          f"apart: {far_off} (of {2 * 24 * 32})")
    assert off_by_one <= 5e-4 * 2 * 24 * 32 and far_off <= 5e-4 * 2 * 24 * 32


def test_host_helpers_equal_the_jax_packages():
    """plan_result_to_diagnostics, controller_diagnostics, depth_to_mm16 and
    image_message give what the JAX package's give on the same host rows."""
    rng = np.random.default_rng(7)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    traj = types.SimpleNamespace(alpha=f32(3), beta=f32(3), gamma=f32(3), a0=f32(3),
                                 v0=f32(3), p0=f32(3), tf=np.float32(1.25))
    res = types.SimpleNamespace(found=True, traj=traj, num_collision_free=5, num_pyramids=3,
                                num_velocity_admissible=7, num_feasible=6, num_candidates=8)
    args = dict(seed=4, vel_cam=f32(3), acc_cam=f32(3), grav_cam=f32(3), goal_world=f32(3),
                reset_time=0.5, stamp=1.25)
    assert tmsgs.to_dict(tbridge.plan_result_to_diagnostics(res, **args)) == \
        jmsgs.to_dict(jbridge.plan_result_to_diagnostics(res, **args))
    cargs = dict(est_pos=f32(3), est_vel=f32(3), est_att=f32(4), traj_id=2, traj_time=0.3,
                 ref_pos=f32(3), ref_vel=f32(3), ref_acc=f32(3), ref_angvel_b=f32(3),
                 ref_thrust=np.float32(9.5), cmd_angvel_b=f32(3), cmd_thrust=np.float32(9.1),
                 batt=7.2, stamp=0.75, desired_yaw=0.1)
    assert tmsgs.to_dict(tbridge.controller_diagnostics(**cargs)) == \
        jmsgs.to_dict(jbridge.controller_diagnostics(**cargs))
    codes = rng.integers(0, 256, (24, 32)).astype(np.int32)
    mm = tbridge.depth_to_mm16(codes, 10.0 / 256.0)
    assert mm.dtype == np.uint16 and np.array_equal(mm, jbridge.depth_to_mm16(codes, 10.0 / 256.0))
    rgb = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
    for arr, enc in ((mm, "16UC1"), (rgb, "rgb8")):
        assert tmsgs.to_dict(tbridge.image_message(arr, enc, 0.5, seq=3)) == \
            jmsgs.to_dict(jbridge.image_message(arr, enc, 0.5, seq=3))
    with pytest.raises(ValueError):
        tbridge.image_message(rgb, "16UC1", 0.0)
    with pytest.raises(ValueError):
        tbridge.image_message(mm, "bgr8", 0.0)


def test_orchard_run_realtime_paced():
    """OrchardBridge.run_realtime at 1 frame a second of wall time (the
    CPU's eager frame takes under a second at 32x24), 2 s: the achieved
    frame rate within 2.5%, the per-frame topics and the wire topics (by
    sim time) in band, one frame per quantum and sim time one frame per
    quantum, no images asked for and none published."""
    tb = tbridge.OrchardBridge(T.make_params(device="cpu", **KW), vehicle_id=1,
                               publish_images=False)
    steps = []
    report = tb.run_realtime(2.0, rate_hz=1.0,
                             on_quantum=lambda b, k: steps.append(int(b.last_outs["step"][-1])))
    if report["late_quanta"] > 0.2 * report["n_quanta"]:
        pytest.skip(f"host overloaded: {report['late_quanta']}/{report['n_quanta']} quanta late")
    assert report["target_frame_hz"] == 1.0
    assert abs(report["achieved_frame_hz"] - 1.0) < 0.025, report
    assert report["bands_ok"] and all(report["bands_ok"].values()), report
    assert report["frames"] == report["n_quanta"] == 2
    spf = int(tb.params.steps_per_frame)
    assert [s - steps[0] for s in steps] == [spf * i for i in range(len(steps))]
    assert report["topic_hz"]["depth"] == 0.0
