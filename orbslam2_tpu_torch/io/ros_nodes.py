"""ROS-style live nodes: topic-driven wrappers over SLAMSystem.

Counterpart of ``orbslam2_tpu/io/ros_nodes.py``; equivalents of the
reference ROS nodes (Examples/ROS/ORB_SLAM2/src/ros_mono.cc, ros_stereo.cc,
ros_rgbd.cc): each node subscribes to image topics, feeds frames to the
system's track_* call and publishes the estimated pose. The reference nodes
are thin shims, a subscriber callback doing cv_bridge + TrackMonocular
(ros_mono.cc:60-75); the stereo and RGB-D ones add an approximate-time
synchronizer (ros_rgbd.cc:68-73).

ROS is not present in every deployment (nor on the card's machine), so the
nodes bind to any object with the small topic-bus interface below:
``LocalTopicBus`` is an in-process implementation used by the tests and the
demos; ``make_rospy_bus`` binds the same nodes to rospy topics where ROS is
installed (import-gated).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from orbslam2_tpu_torch.geometry import se3


# ---------------------------------------------------------------------------
# topic bus
# ---------------------------------------------------------------------------
class LocalTopicBus:
    """Minimal in-process pub/sub with approximate-time pairing, mirroring
    message_filters::Synchronizer semantics (ros_rgbd.cc:68-73)."""

    def __init__(self):
        self._subs: Dict[str, List[Callable]] = {}
        self._lock = threading.Lock()

    def subscribe(self, topic: str, cb: Callable) -> None:
        with self._lock:
            self._subs.setdefault(topic, []).append(cb)

    def publish(self, topic: str, msg) -> None:
        with self._lock:
            subs = list(self._subs.get(topic, ()))
        for cb in subs:
            cb(msg)


@dataclass(eq=False)
class ImageMsg:
    data: np.ndarray       # grayscale [H, W] or color [H, W, 3]
    stamp: float


@dataclass(eq=False)
class PoseMsg:
    tcw: np.ndarray        # [4, 4] world->camera
    stamp: float
    tracked_points: int = 0


class ApproxTimeSync:
    """Pair messages from two topics whose stamps differ by < slop
    (message_filters::sync_policies::ApproximateTime equivalent)."""

    def __init__(self, bus, topic_a: str, topic_b: str,
                 cb: Callable, slop: float = 0.05, queue: int = 10):
        self.cb = cb
        self.slop = slop
        self.queue = queue
        self._a: List[ImageMsg] = []
        self._b: List[ImageMsg] = []
        self._lock = threading.Lock()
        bus.subscribe(topic_a, self._on_a)
        bus.subscribe(topic_b, self._on_b)

    def _on_a(self, msg):
        with self._lock:
            self._a.append(msg)
            self._a = self._a[-self.queue:]
            self._try_match()

    def _on_b(self, msg):
        with self._lock:
            self._b.append(msg)
            self._b = self._b[-self.queue:]
            self._try_match()

    def _try_match(self):
        for a in list(self._a):
            for b in list(self._b):
                if abs(a.stamp - b.stamp) <= self.slop:
                    self._a.remove(a)
                    self._b.remove(b)
                    self.cb(a, b)
                    return


def _to_gray(img: np.ndarray) -> np.ndarray:
    if img.ndim == 3:
        return img.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32)
    return img.astype(np.float32)


# ---------------------------------------------------------------------------
# nodes
# ---------------------------------------------------------------------------
class _NodeBase:
    """Publishes SOLVED poses: the tracker's applied-pose hook fires once
    per applied frame with its frame-accurate stamp. In pipelined tracking
    the track_* return value for steady-state frames is the motion-model
    prediction (the solve is still in flight); the reference's ROS nodes
    publish the solved Tcw (ros_rgbd.cc GrabRGBD), so the pose topic
    carries solved poses delivered one frame later instead. Call flush()
    at end-of-stream to drain the last in-flight frame (the reference
    requires Shutdown() before its savers for the same reason)."""

    def __init__(self, system, bus, pose_topic: str = "/orbslam2/pose"):
        self.system = system
        self.bus = bus
        self.pose_topic = pose_topic
        self.frames = 0
        self.tracked = 0
        system.tracker.applied_pose_cb = self._on_applied

    def _on_applied(self, stamp: float, tcw: Optional[np.ndarray]) -> None:
        if tcw is None:
            return
        self.tracked += 1
        self.bus.publish(self.pose_topic, PoseMsg(
            tcw=tcw, stamp=stamp,
            tracked_points=int(len(self.system.get_tracked_points()))))

    def _publish(self, tcw: Optional[np.ndarray], stamp: float) -> None:
        # per-input bookkeeping only; publication happens in _on_applied
        self.frames += 1

    def flush(self) -> None:
        """Drain the in-flight pipelined frame so its pose publishes."""
        self.system.tracker.flush_frames()


class MonoNode(_NodeBase):
    """ros_mono.cc: one image topic -> TrackMonocular."""

    def __init__(self, system, bus, image_topic: str = "/camera/image_raw",
                 **kw):
        super().__init__(system, bus, **kw)
        bus.subscribe(image_topic, self._on_image)

    def _on_image(self, msg: ImageMsg) -> None:
        tcw = self.system.track_monocular(_to_gray(msg.data), msg.stamp)
        self._publish(tcw, msg.stamp)


class StereoNode(_NodeBase):
    """ros_stereo.cc: synchronized left/right topics -> TrackStereo."""

    def __init__(self, system, bus, left_topic: str = "/camera/left/image_raw",
                 right_topic: str = "/camera/right/image_raw", slop: float = 0.05,
                 **kw):
        super().__init__(system, bus, **kw)
        self._sync = ApproxTimeSync(bus, left_topic, right_topic,
                                    self._on_pair, slop=slop)

    def _on_pair(self, left: ImageMsg, right: ImageMsg) -> None:
        tcw = self.system.track_stereo(_to_gray(left.data),
                                       _to_gray(right.data), left.stamp)
        self._publish(tcw, left.stamp)


class RGBDNode(_NodeBase):
    """ros_rgbd.cc: synchronized rgb/depth topics -> TrackRGBD."""

    def __init__(self, system, bus, rgb_topic: str = "/camera/rgb/image_raw",
                 depth_topic: str = "/camera/depth/image_raw",
                 depth_factor: float = 1.0, slop: float = 0.05, **kw):
        super().__init__(system, bus, **kw)
        self.depth_factor = depth_factor
        self._sync = ApproxTimeSync(bus, rgb_topic, depth_topic,
                                    self._on_pair, slop=slop)

    def _on_pair(self, rgb: ImageMsg, depth: ImageMsg) -> None:
        d = depth.data.astype(np.float32) / self.depth_factor
        tcw = self.system.track_rgbd(_to_gray(rgb.data), d, rgb.stamp)
        self._publish(tcw, rgb.stamp)


# ---------------------------------------------------------------------------
# rospy binding (import-gated)
# ---------------------------------------------------------------------------
def make_rospy_bus():
    """A TopicBus backed by rospy. Raises ImportError without ROS."""
    import rospy  # noqa: F401
    from cv_bridge import CvBridge
    from sensor_msgs.msg import Image
    from geometry_msgs.msg import PoseStamped

    bridge = CvBridge()

    class RospyTopicBus:
        def subscribe(self, topic, cb):
            def _cb(msg):
                img = bridge.imgmsg_to_cv2(msg)
                cb(ImageMsg(data=np.asarray(img), stamp=msg.header.stamp.to_sec()))
            import rospy as _r
            _r.Subscriber(topic, Image, _cb, queue_size=5)

        def publish(self, topic, msg: PoseMsg):
            import rospy as _r
            if not hasattr(self, "_pubs"):
                self._pubs = {}
            if topic not in self._pubs:
                self._pubs[topic] = _r.Publisher(topic, PoseStamped, queue_size=5)
            twc = np.linalg.inv(msg.tcw)
            out = PoseStamped()
            out.header.stamp = _r.Time.from_sec(msg.stamp)
            out.pose.position.x, out.pose.position.y, out.pose.position.z = twc[:3, 3]
            q = se3.to_quaternion(se3.rotation(torch.from_numpy(
                twc.astype(np.float32)))).numpy()  # (x, y, z, w)
            out.pose.orientation.x = float(q[0])
            out.pose.orientation.y = float(q[1])
            out.pose.orientation.z = float(q[2])
            out.pose.orientation.w = float(q[3])
            self._pubs[topic].publish(out)

    return RospyTopicBus()
