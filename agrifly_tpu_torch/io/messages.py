"""AIFS_ROS message schema (the external interface to preserve).

Python dataclass mirrors of AIFS_ROS/hiperlab_rostools/msg/*.msg — field
names and layouts match one-to-one so a thin rospy/rclpy adapter can map
them onto the original topics. Used by io.bridge to stream the simulator
over the reference's topic schema without a ROS dependency.

A copy of `agrifly_tpu/io/messages.py`: the port imports nothing of the JAX
package (tests/test_torch_host_copies.py holds the two equal).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass
class Header:
    stamp: float = 0.0  # seconds
    frame_id: str = ""
    seq: int = 0


@dataclass
class SimulatorTruth:
    header: Header = field(default_factory=Header)
    vehicleID: int = 0
    posx: float = 0.0
    posy: float = 0.0
    posz: float = 0.0
    velx: float = 0.0
    vely: float = 0.0
    velz: float = 0.0
    attyaw: float = 0.0
    attpitch: float = 0.0
    attroll: float = 0.0
    attq0: float = 1.0
    attq1: float = 0.0
    attq2: float = 0.0
    attq3: float = 0.0
    angvelx: float = 0.0
    angvely: float = 0.0
    angvelz: float = 0.0


@dataclass
class MocapOutput:
    header: Header = field(default_factory=Header)
    vehicleID: int = 0
    posx: float = 0.0
    posy: float = 0.0
    posz: float = 0.0
    attyaw: float = 0.0
    attpitch: float = 0.0
    attroll: float = 0.0
    attq0: float = 1.0
    attq1: float = 0.0
    attq2: float = 0.0
    attq3: float = 0.0


@dataclass
class GpsOutput:
    header: Header = field(default_factory=Header)
    vehicleID: int = 0
    posx: float = 0.0
    posy: float = 0.0
    posz: float = 0.0


@dataclass
class ImuOutput:
    header: Header = field(default_factory=Header)
    vehicleID: int = 0
    accmeasx: float = 0.0
    accmeasy: float = 0.0
    accmeasz: float = 0.0
    gyromeasx: float = 0.0
    gyromeasy: float = 0.0
    gyromeasz: float = 0.0


@dataclass
class EstimatorOutput:
    header: Header = field(default_factory=Header)
    vehicleID: int = 0
    posx: float = 0.0
    posy: float = 0.0
    posz: float = 0.0
    velx: float = 0.0
    vely: float = 0.0
    velz: float = 0.0
    attyaw: float = 0.0
    attpitch: float = 0.0
    attroll: float = 0.0
    attq0: float = 1.0
    attq1: float = 0.0
    attq2: float = 0.0
    attq3: float = 0.0
    angvelx: float = 0.0
    angvely: float = 0.0
    angvelz: float = 0.0


@dataclass
class Telemetry:
    header: Header = field(default_factory=Header)
    vehicleID: int = 0
    type: int = 0
    packetNumber: int = 0
    seqNum: int = 0
    accelerometer: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rateGyro: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    attitude: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    velocity: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    attitudeYPR: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    motorForces: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    debugVals: Tuple[float, ...] = tuple([0.0] * 6)
    batteryVoltage: float = 0.0
    panicReason: int = 0
    warnings: int = 0


@dataclass
class RadioCommand:
    header: Header = field(default_factory=Header)
    raw: bytes = b"\x00" * 32
    debugflags: int = 0
    debugvals: Tuple[float, ...] = tuple([0.0] * 10)
    debugtype: int = 0


@dataclass
class JoystickValues:
    header: Header = field(default_factory=Header)
    buttonStart: int = 0
    buttonRed: int = 0
    buttonYellow: int = 0
    buttonBlue: int = 0
    buttonGreen: int = 0
    axes: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)


@dataclass
class PlannerStatistics:
    trajectory_found: bool = False
    NumCollisionFree: int = 0
    NumPyramids: int = 0
    NumVelocityChecks: int = 0
    NumCollisionChecks: int = 0
    NumCostChecks: int = 0
    NumTrajectoriesGenerated: int = 0


@dataclass
class PolynomialTrajectory:
    coeff0: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    coeff1: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    coeff2: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    coeff3: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    coeff4: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    coeff5: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    duration: float = 0.0


@dataclass
class Transform:
    """geometry_msgs/Transform: translation + quaternion rotation."""

    translation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rotation: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)  # w,x,y,z


@dataclass
class PlannerInput:
    """planner_input.msg"""

    random_seed: int = 0
    velocity_D: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    acceleration_D: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    gravity_D: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    goal_W: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclass
class PlannerOutput:
    """planner_output.msg"""

    trajectory_id: int = 0
    planner_statistics: PlannerStatistics = field(default_factory=PlannerStatistics)
    trajectory_parameters_D: PolynomialTrajectory = field(default_factory=PolynomialTrajectory)
    trajectory_reset_time: float = 0.0
    trajectory_transform: Transform = field(default_factory=Transform)


@dataclass
class PlannerDiagnostics:
    """planner_diagnostics.msg = header + planner_input + planner_output."""

    header: Header = field(default_factory=Header)
    input: PlannerInput = field(default_factory=PlannerInput)
    output: PlannerOutput = field(default_factory=PlannerOutput)


@dataclass
class ControllerInput:
    """controller_input.msg"""

    desired_yaw: float = 0.0
    position_estimate_W: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    velocity_estimate_W: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    attitude_estimate_W: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    trajectory_id: int = 0
    trajectory_time: float = 0.0
    position_reference_W: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    velocity_reference_W: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    acceleration_reference_W: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    angular_velocity_reference_B: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    thrust_reference_B: float = 0.0
    current_battery: float = 0.0


@dataclass
class ControllerOutput:
    """controller_output.msg"""

    attitude_command_W: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    angular_velocity_command_B: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    thrust_command_B: float = 0.0
    thrust_adapt_coefficient: float = 1.0


@dataclass
class ControllerDiagnostics:
    """controller_diagnostics.msg = header + controller_input + output."""

    header: Header = field(default_factory=Header)
    input: ControllerInput = field(default_factory=ControllerInput)
    output: ControllerOutput = field(default_factory=ControllerOutput)


@dataclass
class Pose:
    """geometry_msgs/Pose: position + quaternion orientation."""

    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    orientation: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)


@dataclass
class PoseEulerStamped:
    """hiperlab_hardware/msg/PoseEulerStamped.msg: orientation in
    quaternion and euler form with frame + timestamp."""

    header: Header = field(default_factory=Header)
    eulerRPY: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    pose: Pose = field(default_factory=Pose)


@dataclass
class Odometry:
    """nav_msgs/Odometry mirror (T265-style camera odometry).

    The reference simulator node publishes this on
    /camera/t265/odom/sample at 250 Hz (Simulator/main.cpp:201-204,
    358-394): pose = position relative to the initial position in the
    'odom' frame + attitude quaternion; twist = velocity and angular
    velocity expressed in the body ('base_link') frame.
    """

    header: Header = field(default_factory=Header)
    child_frame_id: str = "base_link"
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    orientation: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)  # w,x,y,z
    linear_B: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    angular_B: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclass
class Image:
    """sensor_msgs/Image mirror — the rendered-frame topics.

    The reference's AirSim bridge republishes every rendered frame as
    sensor_msgs/Image on `depthImage` / `rgbImage`
    (AirSimBridge/main.cpp:126-163, 195-215); here the OrchardBridge
    publishes the on-device renderer's frames the same way. `data` is the
    raw row-major byte buffer (rospy accepts bytes for uint8[]).

    Encodings used: '16UC1' for depth (millimeters, little-endian — a
    higher-fidelity superset of the reference's 8-bit depth republish) and
    'rgb8' for color.
    """

    header: Header = field(default_factory=Header)
    height: int = 0
    width: int = 0
    encoding: str = ""
    is_bigendian: int = 0
    step: int = 0  # bytes per row
    data: bytes = b""


def to_dict(msg):
    """Recursively convert a message to plain python (JSON-able).

    Hand-rolled instead of dataclasses.asdict(): asdict deep-copies every
    leaf — including numpy scalars, each via __deepcopy__ — which made
    serialization >50% of the recording surface's wall clock. Messages
    are shallow trees (at most one nested Header/dataclass level), so a
    field walk that leaves scalar/tuple leaves alone is exact."""
    out = {}
    for f in dataclasses.fields(msg):
        v = getattr(msg, f.name)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            v = to_dict(v)
        out[f.name] = v
    return out
