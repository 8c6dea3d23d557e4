"""Convert a ROS1 bag (e.g. short_test3.bag) into the port's replay log
(``io/replay.py``'s ``ReplayLog``, the same npz format as the JAX
package's), on the host: the port's ``tools/bag_to_npz.py``.

    python -m mcl_3dl_tpu_torch.tools.bag_to_npz input.bag output.npz
        [--cloud-topic /cloud] [--map-topic /mapcloud] [--max-points N]

A self-contained ROS1 bag format 2.0 reader (no ROS installation), with
decoders for the message types the reference node consumes
(src/mcl_3dl.cpp:1216-1249):

* ``sensor_msgs/PointCloud2`` (scan and map topics);
* ``nav_msgs/Odometry``;
* ``sensor_msgs/Imu``;
* ``tf2_msgs/TFMessage`` (and ``/tf_static``) for the sensor -> base_link
  and base_link -> odom frames the node gets from TF.

Scans are transformed into the odom frame at their stamp (as accumCloud,
src/mcl_3dl.cpp:274-302, does) with the sensor origin recorded, so the
replay driver feeds the engine without a TF stack.  On the same bag and
arguments the log equals the JAX package's converter's array for array.
"""

from __future__ import annotations

import argparse
import bz2
import struct
from collections import defaultdict

import numpy as np

from mcl_3dl_tpu_torch.io.replay import CLOUD, IMU, ODOM, ReplayLog


# ---------------------------------------------------------------- bag format


def _read_header(data):
    """A bag record header as a dict of raw bytes fields."""
    fields = {}
    off = 0
    while off < len(data):
        (field_len,) = struct.unpack_from("<I", data, off)
        off += 4
        name, _, value = data[off:off + field_len].partition(b"=")
        off += field_len
        fields[name.decode()] = value
    return fields


def read_bag_records(path):
    """``(connections, messages)``: ``{conn_id: {"topic", "type"}}`` and
    ``[(conn_id, receive time, data)]``, chunks decompressed."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"not a ROS1 v2.0 bag: {magic!r}")
        payload = f.read()

    connections = {}
    messages = []

    def parse_stream(buf):
        off = 0
        while off < len(buf):
            (hlen,) = struct.unpack_from("<I", buf, off)
            off += 4
            header = _read_header(buf[off:off + hlen])
            off += hlen
            (dlen,) = struct.unpack_from("<I", buf, off)
            off += 4
            data = buf[off:off + dlen]
            off += dlen
            op = header.get("op", b"\x00")[0]
            if op == 0x07:  # connection
                conn_id = struct.unpack("<I", header["conn"])[0]
                connections[conn_id] = {
                    "topic": header["topic"].decode(),
                    "type": _read_header(data).get("type", b"").decode()}
            elif op == 0x02:  # message data
                conn_id = struct.unpack("<I", header["conn"])[0]
                (t,) = struct.unpack("<Q", header["time"])
                secs, nsecs = t & 0xFFFFFFFF, t >> 32
                messages.append((conn_id, secs + 1e-9 * nsecs, data))
            elif op == 0x05:  # chunk
                compression = header.get("compression", b"none").decode()
                chunk = data
                if compression == "bz2":
                    chunk = bz2.decompress(chunk)
                elif compression == "lz4":
                    try:
                        import lz4.frame  # type: ignore
                    except ImportError:
                        raise RuntimeError("lz4-compressed bag needs lz4")
                    chunk = lz4.frame.decompress(chunk)
                parse_stream(chunk)
            # ops 0x03 (bag header), 0x04 (index), 0x06 (chunk info): skip

    parse_stream(payload)
    return connections, messages


# ------------------------------------------------------------- msg decoding


class Reader:
    """Little-endian reads from a serialized ROS message."""

    def __init__(self, data):
        self.d = data
        self.o = 0

    def u32(self):
        (v,) = struct.unpack_from("<I", self.d, self.o)
        self.o += 4
        return v

    def u8(self):
        v = self.d[self.o]
        self.o += 1
        return v

    def f64(self, n=1):
        v = struct.unpack_from(f"<{n}d", self.d, self.o)
        self.o += 8 * n
        return v if n > 1 else v[0]

    def time(self):
        s = self.u32()
        ns = self.u32()
        return s + 1e-9 * ns

    def string(self):
        n = self.u32()
        v = self.d[self.o:self.o + n].decode("utf-8", "replace")
        self.o += n
        return v

    def bytes(self, n):
        v = self.d[self.o:self.o + n]
        self.o += n
        return v


def decode_header(r):
    """``std_msgs/Header``: ``(stamp, frame_id)``."""
    r.u32()                                           # seq
    stamp = r.time()
    return stamp, r.string()


def decode_odometry(data):
    r = Reader(data)
    stamp, _ = decode_header(r)
    r.string()                                        # child_frame_id
    pose = r.f64(7)
    return stamp, np.asarray(pose[:3]), np.asarray(pose[3:7])


def decode_imu(data):
    r = Reader(data)
    stamp, frame = decode_header(r)
    quat = np.asarray(r.f64(4))
    r.f64(9)  # orientation covariance
    r.f64(3)  # angular velocity
    r.f64(9)
    acc = np.asarray(r.f64(3))
    return stamp, frame, quat, acc


_DTYPES = {7: "<f4", 8: "<f8", 2: "<u1", 4: "<u2", 6: "<u4", 1: "<i1",
           3: "<i2", 5: "<i4"}


def decode_pointcloud2(data):
    """``(stamp, frame, points [N, 3] f32)``, non-finite points dropped."""
    r = Reader(data)
    stamp, frame = decode_header(r)
    height = r.u32()
    width = r.u32()
    fields = []
    for _ in range(r.u32()):
        name = r.string()
        offset = r.u32()
        datatype = r.u8()
        count = r.u32()
        fields.append((name, offset, datatype, count))
    r.u8()                                            # is_bigendian
    point_step = r.u32()
    r.u32()                                           # row_step
    nbytes = r.u32()
    raw = r.bytes(nbytes)

    n = (height * width) if point_step == 0 else nbytes // point_step
    cols = {}
    for name, offset, datatype, _ in fields:
        if name in ("x", "y", "z"):
            cols[name] = np.ndarray((n,), np.dtype(_DTYPES[datatype]),
                                    buffer=raw, offset=offset,
                                    strides=(point_step,)).copy()
    pts = np.stack([cols[k].astype(np.float32) for k in "xyz"], axis=1)
    return stamp, frame, pts[np.isfinite(pts).all(axis=1)]


def decode_tf(data):
    r = Reader(data)
    out = []
    for _ in range(r.u32()):
        stamp, frame = decode_header(r)
        child = r.string()
        t = np.asarray(r.f64(3))
        q = np.asarray(r.f64(4))
        out.append((stamp, frame.lstrip("/"), child.lstrip("/"), t, q))
    return out


# ------------------------------------------------------------ TF resolution


def quat_mul(a, b):
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return np.asarray([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])


def quat_rot(q, v):
    u = q[:3]
    uv = np.cross(u, v)
    return v + 2.0 * (q[3] * uv + np.cross(u, uv))


class TfBuffer:
    """Per (parent, child) time-indexed transforms with nearest-sample
    lookup, plus static transforms."""

    def __init__(self):
        self.dynamic = defaultdict(lambda: ([], [], []))  # t, trans, quat
        self.static = {}
        self.parent_of = {}

    def add(self, stamp, parent, child, t, q, is_static=False):
        self.parent_of[child] = parent
        if is_static:
            self.static[(parent, child)] = (t, q)
        else:
            ts, tr, qu = self.dynamic[(parent, child)]
            ts.append(stamp)
            tr.append(t)
            qu.append(q)

    def finalize(self):
        """Sort each dynamic series by stamp: bag records are only
        approximately time-ordered (chunked writers interleave), and
        ``get`` uses searchsorted."""
        for key, (ts, tr, qu) in self.dynamic.items():
            order = np.argsort(ts, kind="stable")
            self.dynamic[key] = ([ts[i] for i in order],
                                 [tr[i] for i in order],
                                 [qu[i] for i in order])

    def get(self, parent, child, stamp):
        if (parent, child) in self.static:
            return self.static[(parent, child)]
        ts, tr, qu = self.dynamic.get((parent, child), ([], [], []))
        if not ts:
            return None
        i = int(np.clip(np.searchsorted(ts, stamp), 1, len(ts) - 1))
        if abs(ts[i - 1] - stamp) <= abs(ts[i] - stamp):     # the nearest
            i = i - 1
        return tr[i], qu[i]

    def chain(self, target, source, stamp):
        """The transform ``target <- ... <- source`` (walking parents), or
        None where a link is missing."""
        t_acc = np.zeros(3)
        q_acc = np.asarray([0.0, 0.0, 0.0, 1.0])
        frame = source
        hops = 0
        while frame != target:
            parent = self.parent_of.get(frame)
            if parent is None or hops > 16:
                return None
            tq = self.get(parent, frame, stamp)
            if tq is None:
                return None
            t, q = tq
            t_acc = quat_rot(q, t_acc) + t
            q_acc = quat_mul(q, q_acc)
            frame = parent
            hops += 1
        return t_acc, q_acc


# ------------------------------------------------------------------- main


def convert(bag, cloud_topics=None, map_topic="/mapcloud", odom_topic="/odom",
            imu_topic="/imu/data", odom_frame="odom", base_frame="base_link",
            max_points=0, log=print) -> ReplayLog:
    """The bag's events as a ``ReplayLog`` (``cloud_topics`` None: every
    PointCloud2 topic but the map's)."""
    connections, messages = read_bag_records(bag)
    log(f"{len(connections)} connections, {len(messages)} messages")
    for cid, c in sorted(connections.items()):
        log(f"  conn {cid}: {c['topic']} [{c['type']}]")
    topic_of = {cid: c["topic"] for cid, c in connections.items()}
    type_of = {cid: c["type"] for cid, c in connections.items()}

    tfbuf = TfBuffer()                                    # pass 1: TF
    for cid, _, data in messages:
        if type_of[cid] == "tf2_msgs/TFMessage" or topic_of[cid] in (
                "/tf", "/tf_static"):
            for stamp, parent, child, tr, qu in decode_tf(data):
                tfbuf.add(stamp, parent, child, tr, qu,
                          is_static=topic_of[cid] == "/tf_static")
    tfbuf.finalize()

    rng = np.random.default_rng(0)
    cols = {k: [] for k in ("times", "kinds", "odom_pos", "odom_rot",
                            "imu_acc", "imu_rot", "cloud_start", "cloud_len",
                            "cloud_origin", "cloud_frame")}
    cloud_points = []
    frames = {}
    map_points = None
    total = 0
    skipped_tf = 0

    def event(stamp, kind, odom_pos=(0, 0, 0), odom_rot=(0, 0, 0, 0),
              imu_acc=(0, 0, 0), imu_rot=(0, 0, 0, 0), cloud_start=0,
              cloud_len=0, cloud_origin=(0, 0, 0), cloud_frame=0):
        for k, v in dict(times=stamp, kinds=kind, odom_pos=odom_pos,
                         odom_rot=odom_rot, imu_acc=imu_acc, imu_rot=imu_rot,
                         cloud_start=cloud_start, cloud_len=cloud_len,
                         cloud_origin=cloud_origin,
                         cloud_frame=cloud_frame).items():
            cols[k].append(v)

    for cid, _, data in sorted(messages, key=lambda m: m[1]):
        topic, typ = topic_of[cid], type_of[cid]
        if topic == map_topic and typ == "sensor_msgs/PointCloud2":
            map_points = decode_pointcloud2(data)[2]
        elif typ == "nav_msgs/Odometry" and topic == odom_topic:
            stamp, pos, rot = decode_odometry(data)
            event(stamp, ODOM, odom_pos=pos, odom_rot=rot)
        elif typ == "sensor_msgs/Imu" and topic == imu_topic:
            stamp, frame, quat, acc = decode_imu(data)
            # into the base frame through the static TF, where there is one
            st = tfbuf.chain(base_frame, frame, stamp)
            if st is not None:
                _, q = st
                acc = quat_rot(q, acc)
                axis_len = np.linalg.norm(quat[:3])
                if axis_len > 1e-9:
                    axis = quat_rot(q, quat[:3] / axis_len)
                    quat = np.concatenate([axis * axis_len, quat[3:]])
            event(stamp, IMU, imu_acc=acc, imu_rot=quat)
        elif typ == "sensor_msgs/PointCloud2" and (
                cloud_topics is None or topic in cloud_topics):
            stamp, frame, pts = decode_pointcloud2(data)
            tq = tfbuf.chain(odom_frame, frame, stamp)
            if tq is None:
                skipped_tf += 1
                continue
            tr, qu = tq
            pts_odom = quat_rot(qu, pts.astype(np.float64)) + tr
            if max_points and len(pts_odom) > max_points:
                pts_odom = pts_odom[rng.choice(len(pts_odom), max_points,
                                               replace=False)]
            fid = frames.setdefault(frame, len(frames))
            event(stamp, CLOUD, cloud_start=total, cloud_len=len(pts_odom),
                  cloud_origin=tr, cloud_frame=fid)
            cloud_points.append(pts_odom.astype(np.float32))
            total += len(pts_odom)

    if skipped_tf:
        log(f"skipped {skipped_tf} clouds without TF")
    f32 = np.float32
    return ReplayLog(
        times=np.asarray(cols["times"]),
        kinds=np.asarray(cols["kinds"], np.uint8),
        odom_pos=np.asarray(cols["odom_pos"], f32),
        odom_rot=np.asarray(cols["odom_rot"], f32),
        imu_acc=np.asarray(cols["imu_acc"], f32),
        imu_rot=np.asarray(cols["imu_rot"], f32),
        cloud_start=np.asarray(cols["cloud_start"], np.int64),
        cloud_len=np.asarray(cols["cloud_len"], np.int64),
        cloud_origin=np.asarray(cols["cloud_origin"], f32),
        cloud_frame=np.asarray(cols["cloud_frame"], np.uint16),
        cloud_points=(np.concatenate(cloud_points, axis=0) if cloud_points
                      else np.zeros((0, 3), f32)),
        map_points=(map_points if map_points is not None
                    else np.zeros((0, 3), f32)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("bag")
    ap.add_argument("out")
    ap.add_argument("--cloud-topic", default=None,
                    help="scan topic(s), comma separated (default: sniff)")
    ap.add_argument("--map-topic", default="/mapcloud")
    ap.add_argument("--odom-topic", default="/odom")
    ap.add_argument("--imu-topic", default="/imu/data")
    ap.add_argument("--odom-frame", default="odom")
    ap.add_argument("--base-frame", default="base_link")
    ap.add_argument("--max-points", type=int, default=0,
                    help="random-subsample each scan to at most N points")
    a = ap.parse_args(argv)
    log = convert(a.bag, a.cloud_topic.split(",") if a.cloud_topic else None,
                  a.map_topic, a.odom_topic, a.imu_topic, a.odom_frame,
                  a.base_frame, a.max_points)
    log.save(a.out)
    print(f"wrote {a.out}: {len(log.times)} events, {len(log.cloud_points)} "
          f"cloud points, map={len(log.map_points)} points")
    return log


if __name__ == "__main__":
    main()
