"""Pure-python ROS1 wire layer (XML-RPC master + TCPROS), no rospy.

The reference ships as ROS nodes (AIFS_ROS/hiperlab_rostools); this
framework streams the same message schema over an in-process TopicBus and
maps it onto ROS via io/ros_adapter.py. Historically that adapter could
only be *integration*-tested inside a real ROS workspace (rospy + roscore,
absent from this image). This module closes the gap by speaking the actual
ROS1 wire protocols:

  * MiniMaster  — the master's XML-RPC surface (registerPublisher /
    registerSubscriber / unregister* / publisherUpdate fan-out), i.e. a
    miniature roscore.
  * MiniRos     — a rospy-shaped facade (init_node / Publisher /
    Subscriber / Time.from_sec) whose nodes run a real node XML-RPC
    server (requestTopic, publisherUpdate) and real TCPROS sockets with
    the standard connection header (callerid / topic / type / md5sum /
    message_definition).
  * genmsg-compatible schema machinery: .msg text parsing, ROS1 md5sum
    computation (validated against the well-known constants for
    std_msgs/Header, geometry_msgs/Vector3, nav_msgs/Odometry,
    sensor_msgs/Image in tests/test_miniros.py) and little-endian
    serialization.

Because the handshake, md5sums and serialization follow the ROS1 spec, a
node built on MiniRos interoperates with REAL ROS1 nodes/roscore too —
point `make_ros(master_uri=...)` at a live roscore and the adapter's
topics appear like any rospy publisher's.

Message schemas below are the pinned external interface (verbatim
hiperlab_rostools/.msg texts + the standard std_msgs / geometry_msgs /
nav_msgs / sensor_msgs definitions they reference), mirroring
io/messages.py's dataclasses field-for-field.

A copy of `agrifly_tpu/io/miniros.py` (tests/test_torch_host_copies.py
holds the schemas' md5sums and serialized bytes equal to the original's,
and publishes across the two over localhost).
"""

from __future__ import annotations

import hashlib
import io
import socket
import struct
import threading
import time as _time
from typing import Callable, Dict, List, Optional, Tuple
from xmlrpc.client import ServerProxy
from xmlrpc.server import SimpleXMLRPCServer

# ---------------------------------------------------------------------------
# schemas (external interface, pinned)
# ---------------------------------------------------------------------------

SCHEMAS: Dict[str, str] = {
    "std_msgs/Header": "uint32 seq\ntime stamp\nstring frame_id",
    "geometry_msgs/Vector3": "float64 x\nfloat64 y\nfloat64 z",
    "geometry_msgs/Point": "float64 x\nfloat64 y\nfloat64 z",
    "geometry_msgs/Quaternion": "float64 x\nfloat64 y\nfloat64 z\nfloat64 w",
    "geometry_msgs/Pose": (
        "geometry_msgs/Point position\ngeometry_msgs/Quaternion orientation"),
    "geometry_msgs/PoseWithCovariance": (
        "geometry_msgs/Pose pose\nfloat64[36] covariance"),
    "geometry_msgs/Twist": (
        "geometry_msgs/Vector3 linear\ngeometry_msgs/Vector3 angular"),
    "geometry_msgs/TwistWithCovariance": (
        "geometry_msgs/Twist twist\nfloat64[36] covariance"),
    "geometry_msgs/Transform": (
        "geometry_msgs/Vector3 translation\n"
        "geometry_msgs/Quaternion rotation"),
    "nav_msgs/Odometry": (
        "Header header\nstring child_frame_id\n"
        "geometry_msgs/PoseWithCovariance pose\n"
        "geometry_msgs/TwistWithCovariance twist"),
    "sensor_msgs/Image": (
        "Header header\nuint32 height\nuint32 width\nstring encoding\n"
        "uint8 is_bigendian\nuint32 step\nuint8[] data"),
    # hiperlab_rostools/*.msg, verbatim (AIFS_ROS)
    "hiperlab_rostools/simulator_truth": (
        "Header header\nint64 vehicleID\n"
        "float64 posx\nfloat64 posy\nfloat64 posz\n"
        "float64 velx\nfloat64 vely\nfloat64 velz\n"
        "float64 attyaw\nfloat64 attpitch\nfloat64 attroll\n"
        "float64 attq0\nfloat64 attq1\nfloat64 attq2\nfloat64 attq3\n"
        "float64 angvelx\nfloat64 angvely\nfloat64 angvelz"),
    "hiperlab_rostools/estimator_output": (
        "Header header\nint64 vehicleID\n"
        "float64 posx\nfloat64 posy\nfloat64 posz\n"
        "float64 velx\nfloat64 vely\nfloat64 velz\n"
        "float64 attyaw\nfloat64 attpitch\nfloat64 attroll\n"
        "float64 attq0\nfloat64 attq1\nfloat64 attq2\nfloat64 attq3\n"
        "float64 angvelx\nfloat64 angvely\nfloat64 angvelz"),
    "hiperlab_rostools/mocap_output": (
        "Header header\nint64 vehicleID\n"
        "float64 posx\nfloat64 posy\nfloat64 posz\n"
        "float64 attyaw\nfloat64 attpitch\nfloat64 attroll\n"
        "float64 attq0\nfloat64 attq1\nfloat64 attq2\nfloat64 attq3"),
    "hiperlab_rostools/gps_output": (
        "Header header\nint64 vehicleID\n"
        "float64 posx\nfloat64 posy\nfloat64 posz"),
    "hiperlab_rostools/imu_output": (
        "Header header\nint64 vehicleID\n"
        "float64 accmeasx\nfloat64 accmeasy\nfloat64 accmeasz\n"
        "float64 gyromeasx\nfloat64 gyromeasy\nfloat64 gyromeasz"),
    "hiperlab_rostools/telemetry": (
        "Header header\nuint8 vehicleID\nuint8 type\nuint8 packetNumber\n"
        "uint8 seqNum\nfloat64[3] accelerometer\nfloat64[3] rateGyro\n"
        "float64[3] position\nfloat64[3] attitude\nfloat64[3] velocity\n"
        "float64[3] attitudeYPR\nfloat64[4] motorForces\n"
        "float64[6] debugVals\nfloat64 batteryVoltage\nuint8 panicReason\n"
        "uint8 warnings"),
    "hiperlab_rostools/radio_command": (
        "Header header\nuint8[32] raw\nuint8 debugflags\n"
        "float32[10] debugvals\nint32 debugtype"),
    "hiperlab_rostools/joystick_values": (
        "Header header\nuint8 buttonStart\nuint8 buttonRed\n"
        "uint8 buttonYellow\nuint8 buttonBlue\nuint8 buttonGreen\n"
        "float32[4] axes"),
    "hiperlab_rostools/planner_statistics": (
        "bool trajectory_found\nint64 NumCollisionFree\nint64 NumPyramids\n"
        "int64 NumVelocityChecks\nint64 NumCollisionChecks\n"
        "int64 NumCostChecks\nint64 NumTrajectoriesGenerated"),
    "hiperlab_rostools/polynomial_trajectory": (
        "geometry_msgs/Vector3 coeff0\ngeometry_msgs/Vector3 coeff1\n"
        "geometry_msgs/Vector3 coeff2\ngeometry_msgs/Vector3 coeff3\n"
        "geometry_msgs/Vector3 coeff4\ngeometry_msgs/Vector3 coeff5\n"
        "time duration"),
    "hiperlab_rostools/planner_input": (
        "uint64 random_seed\ngeometry_msgs/Vector3 velocity_D\n"
        "geometry_msgs/Vector3 acceleration_D\n"
        "geometry_msgs/Vector3 gravity_D\ngeometry_msgs/Vector3 goal_W"),
    "hiperlab_rostools/planner_output": (
        "uint64 trajectory_id\n"
        "hiperlab_rostools/planner_statistics planner_statistics\n"
        "hiperlab_rostools/polynomial_trajectory trajectory_parameters_D\n"
        "time trajectory_reset_time\n"
        "geometry_msgs/Transform trajectory_transform"),
    "hiperlab_rostools/planner_diagnostics": (
        "Header header\nhiperlab_rostools/planner_input input\n"
        "hiperlab_rostools/planner_output output"),
    "hiperlab_rostools/controller_input": (
        "float64 desired_yaw\ngeometry_msgs/Vector3 position_estimate_W\n"
        "geometry_msgs/Vector3 velocity_estimate_W\n"
        "geometry_msgs/Quaternion attitude_estimate_W\n"
        "uint64 trajectory_id\ntime trajectory_time\n"
        "geometry_msgs/Vector3 position_reference_W\n"
        "geometry_msgs/Vector3 velocity_reference_W\n"
        "geometry_msgs/Vector3 acceleration_reference_W\n"
        "geometry_msgs/Vector3 angular_velocity_reference_B\n"
        "float64 thrust_reference_B\nfloat64 current_battery"),
    "hiperlab_rostools/controller_output": (
        "geometry_msgs/Quaternion attitude_command_W\n"
        "geometry_msgs/Vector3 angular_velocity_command_B\n"
        "float64 thrust_command_B\nfloat64 thrust_adapt_coefficient"),
    "hiperlab_rostools/controller_diagnostics": (
        "Header header\nhiperlab_rostools/controller_input input\n"
        "hiperlab_rostools/controller_output output"),
    "hiperlab_hardware/PoseEulerStamped": (
        "Header header\ngeometry_msgs/Vector3 eulerRPY\n"
        "geometry_msgs/Pose pose"),
}

_BUILTIN = {
    "bool": ("B", 1), "int8": ("b", 1), "uint8": ("B", 1),
    "int16": ("h", 2), "uint16": ("H", 2), "int32": ("i", 4),
    "uint32": ("I", 4), "int64": ("q", 8), "uint64": ("Q", 8),
    "float32": ("f", 4), "float64": ("d", 8),
    "char": ("B", 1), "byte": ("b", 1),
}


class Field:
    __slots__ = ("type", "name", "array_len", "is_array")

    def __init__(self, type_, name, array_len, is_array):
        self.type = type_
        self.name = name
        self.array_len = array_len  # None for variable-length
        self.is_array = is_array


def _resolve(type_name: str, pkg: str) -> str:
    if type_name in ("time", "duration", "string") or type_name in _BUILTIN:
        return type_name
    if type_name == "Header":
        return "std_msgs/Header"
    if "/" not in type_name:
        return f"{pkg}/{type_name}"
    return type_name


def parse_schema(full_type: str) -> List[Field]:
    pkg = full_type.split("/")[0]
    fields = []
    for line in SCHEMAS[full_type].splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or "=" in line:  # no constants in this schema set
            continue
        type_spec, name = line.split()
        is_array, alen = False, None
        if "[" in type_spec:
            base, rest = type_spec.split("[", 1)
            is_array = True
            n = rest.rstrip("]")
            alen = int(n) if n else None
            type_spec = base
        fields.append(Field(_resolve(type_spec, pkg), name, alen, is_array))
    return fields


def _md5_text(full_type: str) -> str:
    """genmsg md5 text: builtin fields keep their declared spec, nested
    fields contribute their own md5 in place of the type (no brackets)."""
    pkg = full_type.split("/")[0]
    out = []
    for line in SCHEMAS[full_type].splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        type_spec, name = line.split()
        base = type_spec.split("[", 1)[0]
        resolved = _resolve(base, pkg)
        if base in _BUILTIN or base in ("time", "duration", "string"):
            out.append(f"{type_spec} {name}")
        else:
            out.append(f"{compute_md5(resolved)} {name}")
    return "\n".join(out)


_MD5_CACHE: Dict[str, str] = {}


def compute_md5(full_type: str) -> str:
    if full_type not in _MD5_CACHE:
        _MD5_CACHE[full_type] = hashlib.md5(
            _md5_text(full_type).encode()).hexdigest()
    return _MD5_CACHE[full_type]


def _collect_deps(full_type: str, seen: List[str]):
    for f in parse_schema(full_type):
        if f.type in _BUILTIN or f.type in ("time", "duration", "string"):
            continue
        if f.type not in seen:
            seen.append(f.type)
            _collect_deps(f.type, seen)


def full_text(full_type: str) -> str:
    """message_definition for the TCPROS header (text + dependencies)."""
    sep = "=" * 80
    parts = [SCHEMAS[full_type]]
    deps: List[str] = []
    _collect_deps(full_type, deps)
    for d in deps:
        parts.append(f"{sep}\nMSG: {d}\n{SCHEMAS[d]}")
    return "\n".join(parts)


# ---------------------------------------------------------------------------
# generated message classes + serialization
# ---------------------------------------------------------------------------


class Time:
    """rospy.Time-shaped (secs/nsecs, from_sec, to_sec)."""

    __slots__ = ("secs", "nsecs")

    def __init__(self, secs=0, nsecs=0):
        self.secs = int(secs)
        self.nsecs = int(nsecs)

    @staticmethod
    def from_sec(t: float) -> "Time":
        secs = int(t)
        return Time(secs, int(round((t - secs) * 1e9)))

    def to_sec(self) -> float:
        return self.secs + self.nsecs * 1e-9

    def __eq__(self, other):
        return (isinstance(other, Time) and self.secs == other.secs
                and self.nsecs == other.nsecs)


_CLASS_CACHE: Dict[str, type] = {}


def message_class(full_type: str) -> type:
    """Generate (and cache) a plain attribute-holder class for a type."""
    if full_type in _CLASS_CACHE:
        return _CLASS_CACHE[full_type]
    fields = parse_schema(full_type)

    def __init__(self, **kw):
        for f in fields:
            if f.name in kw:
                setattr(self, f.name, kw.pop(f.name))
            elif f.is_array:
                if f.type in _BUILTIN and f.array_len is not None:
                    setattr(self, f.name, (0,) * f.array_len)
                else:
                    setattr(self, f.name, ())
            elif f.type == "string":
                setattr(self, f.name, "")
            elif f.type in ("time", "duration"):
                setattr(self, f.name, Time())
            elif f.type in _BUILTIN:
                setattr(self, f.name, False if f.type == "bool" else 0)
            else:
                setattr(self, f.name, message_class(f.type)())
        if kw:
            raise TypeError(f"unknown fields {sorted(kw)} for {full_type}")

    cls = type(full_type.replace("/", "__"), (), {
        "__init__": __init__,
        "_type": full_type,
        "_md5sum": compute_md5(full_type),
        "_fields": fields,
    })
    # string fields default to "" (the generic 0 above covers numerics)
    _CLASS_CACHE[full_type] = cls
    return cls


def _pack_one(buf: io.BytesIO, ftype: str, val):
    if ftype == "string":
        b = val.encode() if isinstance(val, str) else bytes(val)
        buf.write(struct.pack("<I", len(b)))
        buf.write(b)
    elif ftype in ("time", "duration"):
        if isinstance(val, (int, float)):
            val = Time.from_sec(float(val))
        code = "<II" if ftype == "time" else "<ii"
        buf.write(struct.pack(code, val.secs, val.nsecs))
    elif ftype in _BUILTIN:
        buf.write(struct.pack("<" + _BUILTIN[ftype][0],
                              int(val) if _BUILTIN[ftype][0] not in "fd"
                              else float(val)))
    else:
        serialize_into(buf, val, ftype)


def serialize_into(buf: io.BytesIO, msg, full_type: str):
    for f in parse_schema(full_type):
        val = getattr(msg, f.name)
        if f.name == "stamp" and isinstance(val, (int, float)):
            val = Time.from_sec(float(val))
        if f.is_array:
            seq = val
            if f.array_len is None:
                n = len(seq)
                buf.write(struct.pack("<I", n))
            else:
                n = f.array_len
            if f.type == "uint8" and isinstance(seq, (bytes, bytearray)):
                b = bytes(seq[:n]).ljust(n, b"\0")
                buf.write(b)
            elif f.type in _BUILTIN:
                code = _BUILTIN[f.type][0]
                vals = list(seq)[:n] + [0] * max(0, n - len(seq))
                buf.write(struct.pack(f"<{n}{code}", *vals))
            else:
                for v in seq:
                    _pack_one(buf, f.type, v)
        else:
            _pack_one(buf, "string" if _is_string(f) else f.type, val)


def _is_string(f: Field) -> bool:
    return f.type == "string"


# string is not in _BUILTIN; route it explicitly
def _unpack_one(mv, off, ftype):
    if ftype == "string":
        (n,) = struct.unpack_from("<I", mv, off)
        off += 4
        return mv[off:off + n].tobytes().decode(), off + n
    if ftype in ("time", "duration"):
        code = "<II" if ftype == "time" else "<ii"
        s, ns = struct.unpack_from(code, mv, off)
        return Time(s, ns), off + 8
    code, size = _BUILTIN[ftype]
    (v,) = struct.unpack_from("<" + code, mv, off)
    if ftype == "bool":
        v = bool(v)
    return v, off + size


def deserialize_from(mv, off, full_type: str):
    cls = message_class(full_type)
    msg = cls.__new__(cls)
    for f in parse_schema(full_type):
        if f.is_array:
            if f.array_len is None:
                (n,) = struct.unpack_from("<I", mv, off)
                off += 4
            else:
                n = f.array_len
            if f.type == "uint8":
                setattr(msg, f.name, mv[off:off + n].tobytes())
                off += n
            elif f.type in _BUILTIN:
                code, size = _BUILTIN[f.type]
                vals = struct.unpack_from(f"<{n}{code}", mv, off)
                setattr(msg, f.name, tuple(vals))
                off += n * size
            else:
                out = []
                for _ in range(n):
                    v, off = deserialize_from(mv, off, f.type)
                    out.append(v)
                setattr(msg, f.name, tuple(out))
        elif f.type == "string":
            v, off = _unpack_one(mv, off, "string")
            setattr(msg, f.name, v)
        elif f.type in ("time", "duration") or f.type in _BUILTIN:
            v, off = _unpack_one(mv, off, f.type)
            setattr(msg, f.name, v)
        else:
            v, off = deserialize_from(mv, off, f.type)
            setattr(msg, f.name, v)
    return msg, off


def serialize(msg, full_type: Optional[str] = None) -> bytes:
    buf = io.BytesIO()
    serialize_into(buf, msg, full_type or msg._type)
    return buf.getvalue()


def deserialize(data: bytes, full_type: str):
    msg, _ = deserialize_from(memoryview(data), 0, full_type)
    return msg


# ---------------------------------------------------------------------------
# TCPROS framing
# ---------------------------------------------------------------------------


def _pack_header(d: Dict[str, str]) -> bytes:
    body = b"".join(
        struct.pack("<I", len(kv)) + kv
        for kv in (f"{k}={v}".encode() for k, v in d.items()))
    return struct.pack("<I", len(body)) + body


def _read_exact(sock: socket.socket, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            raise ConnectionError("socket closed")
        out += chunk
    return out


def _read_header(sock: socket.socket) -> Dict[str, str]:
    (total,) = struct.unpack("<I", _read_exact(sock, 4))
    body = _read_exact(sock, total)
    off, out = 0, {}
    while off < total:
        (n,) = struct.unpack_from("<I", body, off)
        off += 4
        kv = body[off:off + n].decode()
        off += n
        k, _, v = kv.partition("=")
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# master
# ---------------------------------------------------------------------------


class MiniMaster:
    """A miniature roscore: the XML-RPC master API subset real nodes use."""

    def __init__(self, host="127.0.0.1", port=0):
        self._srv = SimpleXMLRPCServer((host, port), logRequests=False,
                                       allow_none=True)
        self._srv.timeout = 0.1
        self.uri = f"http://{host}:{self._srv.server_address[1]}/"
        self._lock = threading.Lock()
        self._pubs: Dict[str, Dict[str, str]] = {}  # topic -> {caller: api}
        self._subs: Dict[str, Dict[str, str]] = {}
        for name in ("registerPublisher", "unregisterPublisher",
                     "registerSubscriber", "unregisterSubscriber",
                     "getSystemState", "getUri"):
            self._srv.register_function(getattr(self, name), name)
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        daemon=True)
        self._thread.start()

    # --- master API ---
    def getUri(self, caller_id):
        return 1, "", self.uri

    def registerPublisher(self, caller_id, topic, type_, caller_api):
        with self._lock:
            self._pubs.setdefault(topic, {})[caller_id] = caller_api
            sub_apis = list(self._subs.get(topic, {}).values())
            pub_apis = list(self._pubs[topic].values())
        # notify subscribers of the new publisher list (async, real
        # master behavior)
        for api in sub_apis:
            threading.Thread(target=self._notify, args=(api, topic, pub_apis),
                             daemon=True).start()
        return 1, "registered", sub_apis

    def unregisterPublisher(self, caller_id, topic, caller_api):
        with self._lock:
            self._pubs.get(topic, {}).pop(caller_id, None)
        return 1, "", 1

    def registerSubscriber(self, caller_id, topic, type_, caller_api):
        with self._lock:
            self._subs.setdefault(topic, {})[caller_id] = caller_api
            pub_apis = list(self._pubs.get(topic, {}).values())
        return 1, "registered", pub_apis

    def unregisterSubscriber(self, caller_id, topic, caller_api):
        with self._lock:
            self._subs.get(topic, {}).pop(caller_id, None)
        return 1, "", 1

    def getSystemState(self, caller_id):
        with self._lock:
            pubs = [[t, list(d)] for t, d in self._pubs.items() if d]
            subs = [[t, list(d)] for t, d in self._subs.items() if d]
        return 1, "", [pubs, subs, []]

    def _notify(self, api, topic, pub_apis):
        try:
            ServerProxy(api).publisherUpdate("/minimaster", topic, pub_apis)
        except Exception:
            pass

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()


# ---------------------------------------------------------------------------
# node
# ---------------------------------------------------------------------------


class _Publisher:
    def __init__(self, node, topic, cls, latch=False):
        self.node = node
        self.topic = topic
        self.cls = cls
        self.latch = latch
        self._last = None
        self._conns: List[socket.socket] = []
        self._lock = threading.Lock()

    def add_connection(self, sock):
        with self._lock:
            self._conns.append(sock)
            if self.latch and self._last is not None:
                try:
                    sock.sendall(self._last)
                except OSError:
                    pass

    def get_num_connections(self):
        with self._lock:
            return len(self._conns)

    def publish(self, msg):
        data = serialize(msg, self.cls._type)
        frame = struct.pack("<I", len(data)) + data
        with self._lock:
            self._last = frame
            dead = []
            for s in self._conns:
                try:
                    s.sendall(frame)
                except OSError:
                    dead.append(s)
            for s in dead:
                self._conns.remove(s)

    def unregister(self):
        self.node._unregister_pub(self.topic)


class _Subscriber:
    def __init__(self, node, topic, cls, callback):
        self.node = node
        self.topic = topic
        self.cls = cls
        self.callback = callback
        self._connected: Dict[str, socket.socket] = {}
        self._lock = threading.Lock()

    def get_num_connections(self):
        with self._lock:
            return len(self._connected)

    def connect_to(self, pub_api: str):
        with self._lock:
            if pub_api in self._connected:
                return
        try:
            code, _, proto = ServerProxy(pub_api).requestTopic(
                self.node.caller_id, self.topic, [["TCPROS"]])
            if code != 1 or not proto:
                return
            _, host, port = proto
            sock = socket.create_connection((host, port), timeout=5.0)
            sock.sendall(_pack_header({
                "callerid": self.node.caller_id,
                "topic": self.topic,
                "md5sum": self.cls._md5sum,
                "type": self.cls._type,
                "message_definition": full_text(self.cls._type),
                "tcp_nodelay": "1",
            }))
            hdr = _read_header(sock)
            if hdr.get("md5sum") not in (self.cls._md5sum, "*"):
                sock.close()
                return
            with self._lock:
                self._connected[pub_api] = sock
            threading.Thread(target=self._reader, args=(sock, pub_api),
                             daemon=True).start()
        except Exception:
            pass

    def _reader(self, sock, pub_api):
        try:
            while True:
                (n,) = struct.unpack("<I", _read_exact(sock, 4))
                data = _read_exact(sock, n)
                self.callback(deserialize(data, self.cls._type))
        except Exception:
            pass
        finally:
            with self._lock:
                self._connected.pop(pub_api, None)

    def unregister(self):
        self.node._unregister_sub(self.topic)


class MiniNode:
    """One ROS1 node: XML-RPC slave API + TCPROS server + master client."""

    def __init__(self, name: str, master_uri: str, host="127.0.0.1"):
        self.caller_id = f"/{name.lstrip('/')}"
        self.master = ServerProxy(master_uri)
        self._pubs: Dict[str, _Publisher] = {}
        self._subs: Dict[str, _Subscriber] = {}

        # TCPROS server
        self._tcp = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._tcp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._tcp.bind((host, 0))
        self._tcp.listen(16)
        self.tcp_host, self.tcp_port = self._tcp.getsockname()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

        # node XML-RPC (slave API)
        self._xml = SimpleXMLRPCServer((host, 0), logRequests=False,
                                       allow_none=True)
        self.api_uri = f"http://{host}:{self._xml.server_address[1]}/"
        self._xml.register_function(self.requestTopic, "requestTopic")
        self._xml.register_function(self.publisherUpdate, "publisherUpdate")
        self._xml.register_function(lambda cid: (1, "", 0), "getPid")
        self._xml_thread = threading.Thread(
            target=self._xml.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True)
        self._xml_thread.start()
        self._closed = False

    # --- slave API ---
    def requestTopic(self, caller_id, topic, protocols):
        if topic not in self._pubs:
            return 0, f"not a publisher of {topic}", []
        for p in protocols:
            if p and p[0] == "TCPROS":
                return 1, "ready", ["TCPROS", self.tcp_host, self.tcp_port]
        return 0, "no supported protocol", []

    def publisherUpdate(self, caller_id, topic, publishers):
        sub = self._subs.get(topic)
        if sub is not None:
            for api in publishers:
                threading.Thread(target=sub.connect_to, args=(api,),
                                 daemon=True).start()
        return 1, "", 0

    # --- TCPROS server side ---
    def _accept_loop(self):
        while True:
            try:
                sock, _ = self._tcp.accept()
            except OSError:
                return
            threading.Thread(target=self._handshake, args=(sock,),
                             daemon=True).start()

    def _handshake(self, sock):
        try:
            hdr = _read_header(sock)
            topic = hdr.get("topic", "")
            pub = self._pubs.get(topic)
            if pub is None:
                sock.sendall(_pack_header({"error": f"no topic {topic}"}))
                sock.close()
                return
            if hdr.get("md5sum") not in (pub.cls._md5sum, "*"):
                sock.sendall(_pack_header(
                    {"error": "md5sum mismatch"}))
                sock.close()
                return
            sock.sendall(_pack_header({
                "callerid": self.caller_id,
                "md5sum": pub.cls._md5sum,
                "type": pub.cls._type,
                "message_definition": full_text(pub.cls._type),
                "latching": "1" if pub.latch else "0",
            }))
            pub.add_connection(sock)
        except Exception:
            try:
                sock.close()
            except OSError:
                pass

    # --- user API ---
    def advertise(self, topic, cls, latch=False) -> _Publisher:
        topic = "/" + topic.lstrip("/")
        pub = _Publisher(self, topic, cls, latch)
        self._pubs[topic] = pub
        self.master.registerPublisher(self.caller_id, topic, cls._type,
                                      self.api_uri)
        return pub

    def subscribe(self, topic, cls, callback) -> _Subscriber:
        topic = "/" + topic.lstrip("/")
        sub = _Subscriber(self, topic, cls, callback)
        self._subs[topic] = sub
        _, _, pub_apis = self.master.registerSubscriber(
            self.caller_id, topic, cls._type, self.api_uri)
        for api in pub_apis:
            threading.Thread(target=sub.connect_to, args=(api,),
                             daemon=True).start()
        return sub

    def _unregister_pub(self, topic):
        self._pubs.pop(topic, None)
        try:
            self.master.unregisterPublisher(self.caller_id, topic,
                                            self.api_uri)
        except Exception:
            pass

    def _unregister_sub(self, topic):
        self._subs.pop(topic, None)
        try:
            self.master.unregisterSubscriber(self.caller_id, topic,
                                             self.api_uri)
        except Exception:
            pass

    def close(self):
        if self._closed:
            return
        self._closed = True
        for t in list(self._pubs):
            self._unregister_pub(t)
        for t in list(self._subs):
            self._unregister_sub(t)
        try:
            self._tcp.close()
        except OSError:
            pass
        self._xml.shutdown()
        self._xml.server_close()


# ---------------------------------------------------------------------------
# rospy-shaped facade for io/ros_adapter.py
# ---------------------------------------------------------------------------


class _Namespace:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class MiniRos:
    """The rospy surface RosAdapter uses (init_node / Publisher /
    Subscriber / Time), backed by MiniNode over real wire protocols."""

    def __init__(self, master_uri: str):
        self._master_uri = master_uri
        self.node: Optional[MiniNode] = None
        self.Time = Time

    def init_node(self, name, anonymous=False, **_):
        if anonymous:
            name = f"{name}_{int(_time.monotonic() * 1e6) % 1000000}"
        self.node = MiniNode(name, self._master_uri)
        return self.node

    def Publisher(self, topic, cls, queue_size=1, latch=False):
        return self.node.advertise(topic, cls, latch)

    def Subscriber(self, topic, cls, callback):
        return self.node.subscribe(topic, cls, callback)

    def close(self):
        if self.node is not None:
            self.node.close()


# ROS package/class names used by ros_adapter's TOPIC_TABLE
_PKG_TYPES = {
    "hiperlab_rostools": [
        "radio_command", "simulator_truth", "mocap_output", "gps_output",
        "imu_output", "telemetry", "estimator_output", "joystick_values",
        "planner_diagnostics", "controller_diagnostics",
    ],
    "hiperlab_hardware": ["PoseEulerStamped"],
    "nav_msgs": ["Odometry"],
    "sensor_msgs": ["Image"],
    "std_msgs": ["Header"],
}


def make_ros(master_uri: str) -> Tuple[MiniRos, Dict[str, object]]:
    """(rospy-like, {package: namespace-of-classes}) for RosAdapter(ros=...)."""
    pkgs = {
        pkg: _Namespace(**{n: message_class(f"{pkg}/{n}") for n in names})
        for pkg, names in _PKG_TYPES.items()
    }
    return MiniRos(master_uri), pkgs
