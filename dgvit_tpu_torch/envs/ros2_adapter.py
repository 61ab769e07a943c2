"""ROS 2 / Gazebo adapter: the thin host-boundary shim around the real
simulator (env_lab.py GazeboEnv and its subscriber nodes), import-gated so
the package never requires ROS.

Counterpart of `dgvit_tpu/envs/ros2_adapter.py`, with its contract:
  * /cmd_vel Twist publishing and pause/unpause physics stepping
    (env_lab.py:132-136,190-212), with the service-availability wait loop;
  * gazebo/set_entity_state teleports on reset, robot first, then the
    target cone (env_lab.py:152-168,320-321), waited on through the
    future, never by spinning a second executor;
  * latest-value sensor mailboxes fed by a MultiThreadedExecutor daemon
    thread (main.py:199-204), and a /clock mailbox (`sim_now`);
  * image decodes (32FC1, 16UC1, mono8, rgb8/bgr8/8UC3 to mono by
    BT.601 luma) and the all-zero-frame log (env_lab.py:435-436);
  * the RViz goal marker, republished on every reset and step.

Frames go through the port's plain preprocessing chain
(`ops/preprocess.preprocess_depth` / `preprocess_fisheye` /
`resize_bilinear`) on the adapter's device. The JAX adapter calls the XLA
chain (`dgvit_tpu/ops/preprocess.py`), not the Pallas kernel K5, so this
is the same function, not a fall back from K5. The depth chain's noise
comes from one `torch.Generator` on that device, seeded 0 (`_noise`, one
draw a frame; JAX draws frame k's from PRNGKey(k)).

JAX's `use_jax_preprocess` is renamed `device`: JAX stores the flag and
never reads it (its chain is always the XLA one), while the port's chain
runs on a device that the caller chooses, the card unless 'cpu', as every
entry point of the port.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional, Union

import numpy as np
import torch

from dgvit_tpu_torch.core.device import resolve_device
from dgvit_tpu_torch.core.rng import generator
from dgvit_tpu_torch.envs import reward as R
from dgvit_tpu_torch.envs.base import ResetResult, StepResult

try:  # pragma: no cover - exercised only on a ROS 2 machine
    import rclpy
    from rclpy.node import Node
    HAS_ROS2 = True
except ImportError:
    HAS_ROS2 = False
    Node = object  # type: ignore


class GazeboRos2Env:
    """Env-protocol adapter over ROS 2 topics and services. Requires rclpy.

    Multi-robot fleets (`serve/fleet.py`): a per-robot `namespace`
    (topics become <ns>/cmd_vel, <ns>/odom, ...) with distinct
    `robot_name` / `target_name` Gazebo entities, and
    `manage_physics=False`, so the robots do not fight over the global
    pause/unpause services: a fleet runs Gazebo free-running (the
    reference's lockstep 0.1 s pause cycle, env_lab.py:197-212, only makes
    sense for one robot owning the clock)."""

    def __init__(self, cfg, position_records: Optional[list] = None,
                 namespace: str = "", robot_name: Optional[str] = None,
                 target_name: str = "target_cone",
                 manage_physics: bool = True,
                 device: Optional[Union[str, torch.device]] = None):
        if not HAS_ROS2:
            raise ImportError(
                "rclpy not available — GazeboRos2Env needs a ROS2 Humble "
                "environment (reference package.xml). Use KinematicNavEnv or "
                "ReplayEnv for Gazebo-free runs.")
        from geometry_msgs.msg import Twist
        from std_srvs.srv import Empty
        from gazebo_msgs.srv import SetEntityState
        from nav_msgs.msg import Odometry
        from sensor_msgs.msg import Image, LaserScan

        self.cfg = cfg
        self.device = resolve_device(device)
        self._noise_gen = generator(0, self.device)
        self._last_odom = None
        self._last_image = None
        self._scan = None
        self.collision = 0
        self.indice_position = 0
        self.records = position_records or []
        self.dist_old = 1.0
        self.goalX = self.goalY = 2.0
        if not (namespace == "" or namespace.startswith("/")):
            raise ValueError("namespace must be '' or start with '/' (ROS2 "
                             "convention)")
        self.namespace = namespace
        self.robot_name = robot_name or getattr(cfg.train, "robot", "scout")
        self.target_name = target_name
        self.manage_physics = manage_physics
        self.DT = 0.1  # sim-time per action step (env_lab.py:204)

        try:
            rclpy.init(args=None)
        except RuntimeError:  # context already initialized (a fleet: one
            pass               # rclpy context, one node per robot)
        self.node = rclpy.create_node(
            "dgvit_env" + namespace.replace("/", "_"))
        self.vel_pub = self.node.create_publisher(
            Twist, f"{namespace}/cmd_vel", 1)
        # physics and teleport services are Gazebo-global (never namespaced)
        self.unpause = self.node.create_client(Empty, "/unpause_physics")
        self.pause = self.node.create_client(Empty, "/pause_physics")
        self.set_state = self.node.create_client(SetEntityState,
                                                 "gazebo/set_entity_state")
        # RViz goal marker (env_lab.py:135,254-271); a ROS 2 install
        # without visualization_msgs skips it
        self._marker_pub = None
        try:
            from visualization_msgs.msg import Marker, MarkerArray  # noqa: F401
            self._marker_pub = self.node.create_publisher(
                MarkerArray, f"{namespace}/goal_mark_array", 3)
        except ImportError:
            pass
        # /clock mailbox: with free-running physics sim time advances by
        # wall-clock x real-time factor, so durations come from the sim
        # clock when it is published (gazebo_ros use_sim_time)
        self._sim_clock = None
        try:
            from rosgraph_msgs.msg import Clock
            self.node.create_subscription(Clock, "/clock", self._on_clock, 10)
        except ImportError:
            pass

        topic = {"depth_image": f"{namespace}/camera/depth/image_raw",
                 "fish_image": f"{namespace}/camera_fesh/image_raw",
                 "image": f"{namespace}/camera/image_raw"}[cfg.env.vis_sensor]
        self.node.create_subscription(Image, topic, self._on_image, 10)
        self.node.create_subscription(Odometry, f"{namespace}/odom",
                                      self._on_odom, 10)
        self.node.create_subscription(LaserScan,
                                      f"{namespace}/front_laser/scan",
                                      self._on_scan, 1)
        self._executor = rclpy.executors.MultiThreadedExecutor()
        self._executor.add_node(self.node)
        self._thread = threading.Thread(target=self._executor.spin,
                                        daemon=True)
        self._thread.start()

    # -- sensor mailboxes (latest wins, as env_lab.py:24-28) ---------------
    def _on_odom(self, msg):
        self._last_odom = msg

    def _on_scan(self, msg):
        self._scan = msg

    def _on_clock(self, msg):
        self._sim_clock = (float(msg.clock.sec)
                           + float(msg.clock.nanosec) * 1e-9)

    def sim_now(self) -> Optional[float]:
        """The latest /clock sim time in seconds, or None before the first
        tick (no /clock publisher, or a world not yet unpaused)."""
        return self._sim_clock

    def _on_image(self, msg):
        """Raw bytes -> array at the host boundary; the chain runs later,
        on the adapter's device."""
        h, w = msg.height, msg.width
        if msg.encoding in ("32FC1",):
            img = np.frombuffer(msg.data, np.float32).reshape(h, w)
        elif msg.encoding in ("16UC1",):
            img = np.frombuffer(msg.data, np.uint16).reshape(h, w)
        elif msg.encoding in ("rgb8", "bgr8", "8UC3"):
            # cv_bridge imgmsg_to_cv2(..., "mono8") (env_lab.py:460-471):
            # ITU-R BT.601 luma, 8UC3 taken as BGR as OpenCV does
            rgb = np.frombuffer(msg.data, np.uint8).reshape(h, w, 3)
            if msg.encoding != "rgb8":
                rgb = rgb[..., ::-1]
            img = (rgb @ np.array([0.299, 0.587, 0.114], np.float32)).astype(
                np.uint8)
        else:  # mono8
            img = np.frombuffer(msg.data, np.uint8).reshape(h, w)
        if not img.any():  # all-zero frame detection (env_lab.py:435-436)
            self.node.get_logger().error("Image null!")
        self._last_image = img

    # -- physics stepping ----------------------------------------------------
    def _call_empty(self, client):
        from std_srvs.srv import Empty

        while not client.wait_for_service(timeout_sec=1.0):
            self.node.get_logger().info("service not available, waiting...")
        client.call_async(Empty.Request())

    def _set_entity(self, name, x, y, qz=0.0, qw=1.0):
        from gazebo_msgs.srv import SetEntityState

        req = SetEntityState.Request()
        req.state.name = name
        req.state.pose.position.x = float(x)
        req.state.pose.position.y = float(y)
        req.state.pose.orientation.z = float(qz)
        req.state.pose.orientation.w = float(qw)
        fut = self.set_state.call_async(req)
        # no spin here: the node spins in its own background executor,
        # which completes this future, and in a fleet N concurrent resets
        # would all spin the global executor at once
        done = threading.Event()
        fut.add_done_callback(lambda _fut: done.set())
        if fut.done():  # completed before the callback was registered
            done.set()
        if not done.wait(timeout=5.0):
            self.node.get_logger().error(
                f"set_entity_state({name}) timed out after 5 s")

    def _publish_goal_marker(self):
        """RViz goal (env_lab.py:254-271): one flat white cylinder in the
        odom frame at the current goal, on every reset and step."""
        if self._marker_pub is None:
            return
        from visualization_msgs.msg import Marker, MarkerArray

        marker = Marker()
        marker.header.frame_id = "odom"
        marker.type = Marker.CYLINDER
        marker.action = Marker.ADD
        marker.scale.x = 0.3
        marker.scale.y = 0.3
        marker.scale.z = 0.01
        marker.color.a = 1.0
        marker.color.r = 1.0
        marker.color.g = 1.0
        marker.color.b = 1.0
        marker.pose.orientation.w = 1.0
        marker.pose.position.x = float(self.goalX)
        marker.pose.position.y = float(self.goalY)
        marker.pose.position.z = 0.0
        arr = MarkerArray()
        arr.markers.append(marker)
        self._marker_pub.publish(arr)

    def _noise(self, shape) -> torch.Tensor:
        """The standard normal draws of one depth frame's noise."""
        return torch.randn(shape, dtype=torch.float32, device=self.device,
                           generator=self._noise_gen)

    def _preprocess(self, raw: np.ndarray) -> np.ndarray:
        """One raw frame -> the (128, 160, 1) state, on the device."""
        from dgvit_tpu_torch.ops import preprocess as pp

        x = torch.from_numpy(raw[None].astype(np.float32)).to(self.device)
        sensor = self.cfg.env.vis_sensor
        if sensor == "depth_image":
            dtype_in = "float" if raw.dtype.kind == "f" else "uint16"
            out = pp.preprocess_depth(x, dtype_in=dtype_in,
                                      noise=self._noise(x.shape))[0]
        elif sensor == "fish_image":
            out = pp.preprocess_fisheye(x)[0]
        else:
            out = pp.resize_bilinear(x, (128, 160))[0]
            out = out / pp._scalar(255.0, out)
        return out.cpu().numpy()[..., None]

    def _pose(self):
        od = self._last_odom
        x = od.pose.pose.position.x
        y = od.pose.pose.position.y
        q = od.pose.pose.orientation
        yaw = float(np.asarray(R.quaternion_yaw(q.w, q.x, q.y, q.z)))
        return x, y, yaw

    # -- Env protocol ---------------------------------------------------------
    def reset(self) -> ResetResult:
        if self.records:
            rec = self.records[self.indice_position]
            self.indice_position = ((self.indice_position + 1)
                                    % len(self.records))
            self._set_entity(self.robot_name,
                             rec["xR"], rec["yR"],
                             rec.get("quaterZ", 0), rec.get("quaterW", 1))
            self._set_entity(self.target_name, rec["xG"], rec["yG"])
            self.goalX, self.goalY = rec["xG"], rec["yG"]
        self._publish_goal_marker()
        if self.manage_physics:
            self._call_empty(self.unpause)
            time.sleep(0.2)
            self._call_empty(self.pause)
        else:  # free-running sim: let the teleport settle
            time.sleep(0.2)
        while self._last_image is None or self._last_odom is None:
            time.sleep(0.05)
        x, y, yaw = self._pose()
        self.dist_old = math.hypot(x - self.goalX, y - self.goalY)
        state = self._preprocess(self._last_image)
        to_goal = np.asarray(R.polar_goal(x, y, self.goalX, self.goalY, yaw),
                             np.float32)
        return ResetResult(state=state, xR=x, yR=y, to_goal=to_goal)

    def step(self, action, t: int) -> StepResult:
        from geometry_msgs.msg import Twist

        cmd = Twist()
        cmd.linear.x = float(action[0])
        cmd.angular.z = float(action[1])
        self.vel_pub.publish(cmd)
        self._publish_goal_marker()
        if self.manage_physics:
            self._call_empty(self.unpause)
            time.sleep(self.DT)  # 0.1 s sim step (env_lab.py:204)
            self._call_empty(self.pause)
        else:  # fleet mode: real-time sim, fixed control cadence
            time.sleep(self.DT)

        scan = self._scan
        ranges = np.asarray(scan.ranges, np.float32)
        ranges[~np.isfinite(ranges)] = 10.0
        col, _ = R.laser_collision(ranges, self.cfg.env.collision_range)
        col = bool(col)
        x, y, yaw = self._pose()
        dist = math.hypot(x - self.goalX, y - self.goalY)
        out = R.step_reward(self.dist_old, dist, col,
                            float(action[0]), float(action[1]),
                            goal_radius=self.cfg.env.goal_radius,
                            r_target=self.cfg.env.r_target,
                            r_collision=self.cfg.env.r_collision,
                            heuristic_scale=self.cfg.env.heuristic_scale,
                            clip=tuple(self.cfg.env.reward_clip))
        self.dist_old = float(out.dist)
        if col:
            self.collision += 1
        state = self._preprocess(self._last_image)
        to_goal = np.asarray(R.polar_goal(x, y, self.goalX, self.goalY, yaw,
                                          float(action[0]), float(action[1])),
                             np.float32)
        return StepResult(state=state, reward=float(out.reward),
                          done=bool(out.done), to_goal=to_goal,
                          target=bool(out.target))

    def stop(self):
        from geometry_msgs.msg import Twist

        self.vel_pub.publish(Twist())
