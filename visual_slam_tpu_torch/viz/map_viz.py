"""3D map visualization + scene export (port of
``visual_slam_tpu.viz.map_viz``).

Point-cloud + camera-frusta scene, shared-landmark reprojection overlays,
keypoint display, over the port's ``Map``, ``Frame`` and ``KeyFrame``.
Open3D is optional (absent in headless environments); the
geometry-assembly half (``export_scene``) always works and returns plain
arrays, which is also the PLY export path. Feature blocks may live on the
card: they are read through their host copies (``Frame.keypoints``,
``Frame.valid_mask``).
"""
from __future__ import annotations

import numpy as np

try:
    import open3d as o3d  # type: ignore

    _HAS_O3D = True
except ImportError:  # pragma: no cover
    o3d = None
    _HAS_O3D = False


def frustum_lines(T_w2c: np.ndarray, K: np.ndarray, width: int, height: int, scale: float = 0.3):
    """Camera frustum wireframe: (5, 3) points (center + 4 image corners at
    unit depth * scale) and (8, 2) line index pairs."""
    Kinv = np.linalg.inv(K)
    corners_px = np.array(
        [[0, 0, 1], [width, 0, 1], [width, height, 1], [0, height, 1]], np.float64
    )
    rays = corners_px @ Kinv.T * scale
    R = T_w2c[:3, :3]
    t = T_w2c[:3, 3]
    C = -R.T @ t
    pts = np.vstack([C[None, :], (rays @ R) + C])  # rays in world: R^T ray + C
    lines = np.array([[0, 1], [0, 2], [0, 3], [0, 4], [1, 2], [2, 3], [3, 4], [4, 1]])
    return pts, lines


class MapVisualizer:
    def __init__(self, camera=None):
        self.camera = camera

    # -- scene assembly (always available) ---------------------------------
    def export_scene(self, slam_map) -> dict:
        """Plain-array scene: landmark positions/colors + keyframe poses."""
        points, colors = [], []
        for mp in slam_map.get_map_points():
            if mp.is_bad:
                continue
            points.append(mp.position)
            colors.append(np.asarray(mp.color, np.float64) / 255.0)
        kfs = slam_map.get_keyframes()
        poses = np.stack([kf.T_w2c for kf in kfs]) if kfs else np.zeros((0, 4, 4))
        return {
            "points": np.asarray(points).reshape(-1, 3),
            "colors": np.asarray(colors).reshape(-1, 3),
            "keyframe_poses": poses,
            "keyframe_ids": [kf.keyframe_id for kf in kfs],
        }

    def save_ply(self, slam_map, path: str) -> None:
        """ASCII PLY point-cloud export (works without open3d)."""
        scene = self.export_scene(slam_map)
        pts, cols = scene["points"], (scene["colors"] * 255).astype(np.uint8)
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {len(pts)}\n")
            f.write("property float x\nproperty float y\nproperty float z\n")
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
            f.write("end_header\n")
            for p, c in zip(pts, cols):
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")

    # -- interactive display (requires open3d) -----------------------------
    def show_scene(self, slam_map, K=None, width: int = 640, height: int = 480) -> None:
        """Point cloud, keyframe frusta and the world axes in an open3d window."""
        if not _HAS_O3D:
            raise RuntimeError("open3d not available; use export_scene()/save_ply()")
        scene = self.export_scene(slam_map)
        geoms = []
        pc = o3d.geometry.PointCloud()
        pc.points = o3d.utility.Vector3dVector(scene["points"])
        pc.colors = o3d.utility.Vector3dVector(scene["colors"])
        geoms.append(pc)
        K = K if K is not None else (self.camera.K if self.camera is not None else np.eye(3))
        for T in scene["keyframe_poses"]:
            pts, lines = frustum_lines(T, K, width, height)
            ls = o3d.geometry.LineSet(
                o3d.utility.Vector3dVector(pts), o3d.utility.Vector2iVector(lines)
            )
            ls.paint_uniform_color([0.0, 0.6, 1.0])
            geoms.append(ls)
        geoms.append(o3d.geometry.TriangleMesh.create_coordinate_frame(size=0.5))
        o3d.visualization.draw_geometries(geoms)

    def show_matches(self, slam_map, kf1, kf2, K) -> np.ndarray:
        """Shared-landmark reprojection overlay between two keyframes.
        Returns the rendered image pair."""
        shared = []
        for key1, mp in list(kf1.map_points.items()):
            if mp.is_bad:
                continue
            kp2 = mp.observations.get(kf2.keyframe_id, 0)
            if kp2 is not None:
                shared.append((key1[1], kp2, mp))
        from .feature_viz import FeatureVisualizer

        fv = FeatureVisualizer()
        xy1 = np.array([kf1.keypoints(0)[i1] for i1, _, _ in shared]).reshape(-1, 2)
        xy2 = np.array([kf2.keypoints(0)[i2] for _, i2, _ in shared]).reshape(-1, 2)
        img1 = kf1.get_image(0)
        img2 = kf2.get_image(0)
        if img1 is None or img2 is None:
            return np.zeros((1, 1, 3), np.uint8)
        return fv.draw_matches(img1, xy1, img2, xy2)

    def show_keypoints(self, frame, cam_id: int = 0) -> np.ndarray:
        """The valid keypoints of camera ``cam_id`` drawn on its image."""
        from .feature_viz import FeatureVisualizer

        return FeatureVisualizer().draw_keypoints(
            frame.get_image(cam_id), frame.keypoints(cam_id), frame.valid_mask(cam_id)
        )
