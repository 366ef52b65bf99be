"""Optional rospy adapter: mirror a TopicBus onto real ROS topics.

The reference's external interface is the AIFS_ROS message schema
(hiperlab_rostools/msg/*.msg, hiperlab_hardware/msg/PoseEulerStamped.msg);
io/messages.py carries 1:1 dataclass mirrors and io/bridge.py streams the
sim over an in-process TopicBus. This module is the last inch: when rospy
and the hiperlab message packages are importable (a real ROS Noetic
workspace), `RosAdapter` republishes every TopicBus message on the
equally-named ROS topic and forwards inbound `radio_command{id}` /
`joystick_values` ROS messages onto the bus — the drop-in equivalent of
running the reference's `simulator` node.

Without rospy the adapter still runs over REAL ROS1 wire protocols via
`io/miniros.py` (pure-python XML-RPC master/slave + TCPROS): pass
``ros=miniros.make_ros(master_uri)`` pointing at a MiniMaster or a live
roscore.

A copy of `agrifly_tpu/io/ros_adapter.py` on the port's `io/messages`
(tests/test_torch_host_copies.py holds the mapping table and the copies
equal to the original's, and runs the adapter over localhost TCPROS).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Optional, Tuple, Type

from agrifly_tpu_torch.io import messages as msgs

# topic name pattern -> (mirror dataclass, ROS package, ROS message name).
# Patterns are regexes over full topic names; `{id}`-style suffixes in the
# reference become trailing integers here (radio_command3, mocap_output3).
TOPIC_TABLE: Tuple[Tuple[str, Type, str, str], ...] = (
    (r"radio_command\d+", msgs.RadioCommand, "hiperlab_rostools", "radio_command"),
    (r"simulator_truth\d+", msgs.SimulatorTruth, "hiperlab_rostools", "simulator_truth"),
    (r"mocap_output\d+", msgs.MocapOutput, "hiperlab_rostools", "mocap_output"),
    (r"gps_output\d+", msgs.GpsOutput, "hiperlab_rostools", "gps_output"),
    (r"imu_output\d+", msgs.ImuOutput, "hiperlab_rostools", "imu_output"),
    (r"telemetry\d+", msgs.Telemetry, "hiperlab_rostools", "telemetry"),
    (r"estimator\d+", msgs.EstimatorOutput, "hiperlab_rostools", "estimator_output"),
    (r"joystick_values", msgs.JoystickValues, "hiperlab_rostools", "joystick_values"),
    (r"planner_diagnostics\d*", msgs.PlannerDiagnostics, "hiperlab_rostools", "planner_diagnostics"),
    (r"controller_diagnostics\d*", msgs.ControllerDiagnostics, "hiperlab_rostools", "controller_diagnostics"),
    (r"/camera/t265/odom/sample", msgs.Odometry, "nav_msgs", "Odometry"),
    (r"pose_euler\d*", msgs.PoseEulerStamped, "hiperlab_hardware", "PoseEulerStamped"),
    # rendered-frame topics + handshake flag (AirSimBridge/main.cpp:195-215)
    (r"depthImage\d*", msgs.Image, "sensor_msgs", "Image"),
    (r"rgbImage\d*", msgs.Image, "sensor_msgs", "Image"),
    (r"imageReceivedFlag\d*", msgs.Header, "std_msgs", "Header"),
    (r"imagePoll\d*", msgs.Header, "std_msgs", "Header"),
)

# mirrors that only appear nested inside other messages
NESTED_MIRRORS = (
    msgs.Header, msgs.PlannerInput, msgs.PlannerOutput, msgs.PlannerStatistics,
    msgs.PolynomialTrajectory, msgs.Transform, msgs.ControllerInput,
    msgs.ControllerOutput, msgs.Pose,
)


def lookup(topic: str) -> Optional[Tuple[Type, str, str]]:
    """Mirror class + ROS (package, message) for a topic name, or None."""
    for pattern, cls, pkg, name in TOPIC_TABLE:
        if re.fullmatch(pattern, topic):
            return cls, pkg, name
    return None


def copy_to_ros(mirror, ros_msg, time_from_sec=None):
    """Field-by-field copy of a mirror dataclass onto a ROS message object.

    Field names match the .msg files 1:1 by construction; nested
    dataclasses recurse onto the equally-named ROS sub-message. Fields the
    target lacks are skipped (forward compatible), tuples are assigned
    as-is (rospy accepts sequences for fixed arrays).

    Mirror Headers carry the stamp as float seconds while std_msgs/Header
    wants a rospy.Time; pass ``time_from_sec=rospy.Time.from_sec`` to
    convert ``stamp`` fields during the copy.
    """
    for f in dataclasses.fields(mirror):
        if not hasattr(ros_msg, f.name):
            continue
        val = getattr(mirror, f.name)
        if dataclasses.is_dataclass(val):
            copy_to_ros(val, getattr(ros_msg, f.name), time_from_sec)
        elif f.name == "stamp" and time_from_sec is not None:
            setattr(ros_msg, f.name, time_from_sec(val))
        else:
            setattr(ros_msg, f.name, val)
    return ros_msg


def copy_from_ros(ros_msg, cls):
    """Build a mirror dataclass from a ROS message (inverse of copy_to_ros).

    rospy.Time-valued stamps (anything with a ``to_sec``) collapse back to
    float seconds.
    """
    kwargs = {}
    for f in dataclasses.fields(cls):
        if not hasattr(ros_msg, f.name):
            continue
        val = getattr(ros_msg, f.name)
        default = (f.default_factory() if f.default_factory is not dataclasses.MISSING
                   else f.default)
        if dataclasses.is_dataclass(default):
            kwargs[f.name] = copy_from_ros(val, type(default))
        elif isinstance(default, tuple):
            kwargs[f.name] = tuple(val)
        elif hasattr(val, "to_sec"):
            kwargs[f.name] = val.to_sec()
        else:
            kwargs[f.name] = val
    return cls(**kwargs)


def odometry_to_ros(mirror, ros_msg, time_from_sec=None):
    """Explicit Odometry mirror -> nav_msgs/Odometry mapping.

    The mirror keeps the T265 sample flat (position / w-first orientation /
    body-frame twist, Simulator/main.cpp:358-394 shape); nav_msgs nests
    them under pose.pose / twist.twist with x,y,z,w quaternions, so a
    name-matched field copy cannot reach them.
    """
    copy_to_ros(mirror.header, ros_msg.header, time_from_sec)
    ros_msg.child_frame_id = mirror.child_frame_id
    p = ros_msg.pose.pose.position
    p.x, p.y, p.z = mirror.position
    q = ros_msg.pose.pose.orientation
    q.w, q.x, q.y, q.z = mirror.orientation  # mirror is w-first
    lin = ros_msg.twist.twist.linear
    lin.x, lin.y, lin.z = mirror.linear_B
    ang = ros_msg.twist.twist.angular
    ang.x, ang.y, ang.z = mirror.angular_B
    return ros_msg


def odometry_from_ros(ros_msg):
    """nav_msgs/Odometry -> Odometry mirror (inverse of odometry_to_ros)."""
    p = ros_msg.pose.pose.position
    q = ros_msg.pose.pose.orientation
    lin = ros_msg.twist.twist.linear
    ang = ros_msg.twist.twist.angular
    return msgs.Odometry(
        header=copy_from_ros(ros_msg.header, msgs.Header),
        child_frame_id=ros_msg.child_frame_id,
        position=(p.x, p.y, p.z),
        orientation=(q.w, q.x, q.y, q.z),
        linear_B=(lin.x, lin.y, lin.z),
        angular_B=(ang.x, ang.y, ang.z),
    )


def _import_ros():
    """(rospy, {package: module}) or None when ROS is absent."""
    try:  # pragma: no cover - exercised only in a ROS workspace
        import rospy  # noqa: F401
        import importlib

        pkgs = {}
        for pkg in ("hiperlab_rostools.msg", "hiperlab_hardware.msg",
                    "nav_msgs.msg", "sensor_msgs.msg", "std_msgs.msg"):
            pkgs[pkg.split(".")[0]] = importlib.import_module(pkg)
        return rospy, pkgs
    except Exception:
        return None


class RosAdapter:
    """Bidirectional TopicBus <-> ROS bridge (active only under ROS).

    outbound: every bus publish on a TOPIC_TABLE topic is converted with
    copy_to_ros and republished under the same name.
    inbound: radio_command{id} and joystick_values subscriptions convert
    with copy_from_ros and publish onto the bus.
    """

    INBOUND = (r"radio_command\d+", r"joystick_values", r"imagePoll\d*")

    def __init__(self, bus, vehicle_ids=(1,), node_name="agrifly_tpu_sim",
                 queue_size=1, ros=None):
        """ros: optional (rospy_like, {package: namespace}) pair. Pass
        agrifly_tpu_torch.io.miniros.make_ros(master_uri) to run the adapter over
        the pure-python ROS1 wire layer (real XML-RPC + TCPROS, no rospy) —
        against the in-image MiniMaster or a real roscore. When None, a
        real rospy workspace is auto-detected as before."""
        self.bus = bus
        self._ros = ros if ros is not None else _import_ros()
        self.active = self._ros is not None
        self._pubs: Dict[str, Callable] = {}
        if not self.active:
            return
        rospy, pkgs = self._ros
        rospy.init_node(node_name, anonymous=True)
        self._rospy, self._pkgs = rospy, pkgs
        self._time_from_sec = rospy.Time.from_sec
        bus.subscribe_all(self._on_bus_message)
        for vid in vehicle_ids:
            self._subscribe_inbound(f"radio_command{vid}")
        self._subscribe_inbound("joystick_values")

    @classmethod
    def is_inbound(cls, topic) -> bool:
        """True for topics that originate on the ROS side (ROS -> bus)."""
        return any(re.fullmatch(p, topic) for p in cls.INBOUND)

    # pragma: no cover - the ROS paths below run only in a ROS workspace
    def _ros_class(self, pkg, name):
        return getattr(self._pkgs[pkg], name)

    def _subscribe_inbound(self, topic):
        hit = lookup(topic)
        if hit is None:
            return
        cls, pkg, name = hit
        self._rospy.Subscriber(
            topic, self._ros_class(pkg, name),
            lambda m, t=topic, c=cls: self.bus.publish(t, copy_from_ros(m, c)),
        )

    def _on_bus_message(self, topic, msg):
        # Inbound topics were injected onto the bus *from* ROS; in ROS1 a
        # node receives its own publications, so re-mirroring them back
        # would loop radio_command/joystick forever.
        if self.is_inbound(topic):
            return
        hit = lookup(topic)
        if hit is None:
            return
        cls, pkg, name = hit
        if topic not in self._pubs:
            self._pubs[topic] = self._rospy.Publisher(
                topic, self._ros_class(pkg, name), queue_size=1)
        ros_msg = self._ros_class(pkg, name)()
        if cls is msgs.Odometry:
            out = odometry_to_ros(msg, ros_msg, self._time_from_sec)
        else:
            out = copy_to_ros(msg, ros_msg, self._time_from_sec)
        self._pubs[topic].publish(out)
