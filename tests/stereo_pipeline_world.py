"""The world, configuration and run of ``bench.py``'s ``bench_stereo_pipeline``
(bench.py:468-541), for either package: numpy only, generic over the
``Config`` class, shared by ``scripts/stereo_pipeline_reference.py`` (either
package on the CPU) and ``chip_smoke.py``'s stereo pipeline phase (the port
on the card).

The world is ``bench.synth_kitti_frames(48, seed=3, baseline=0.54, step=0.6,
n_sprites=1500)``: 48 rectified KITTI-width pairs (376x1240, f = 718.856,
the right camera 0.54 m along the rig's +x). The configuration is the
bench's: stereo, 2000 features, keyframe interval 4, self-promoting chunks
of 8 with a heavy boundary every second promotion, f16 upload, a BA of at
most 4096 landmarks over a window of 16 keyframes, bucket floors 32 / 2048.
The run is the bench's too: a bootstrap within the first 6 pairs, a warm-up
through two heavy cycles, a timed window that ends on a chunk boundary, then
``flush()``; the ATE is metric (no scale alignment).

The small worlds (``small_frames``, ``small_config``) are the JAX package's
stereo ``CompiledSLAM`` tests' (tests/test_compiled_slam.py): ``single``,
``test_compiled_slam_stereo``'s 10 pairs (seed 6) tracked one by one;
``promotion``, ``test_compiled_slam_stereo_device_promotion``'s 17 pairs
(seed 11, yaw 0.01 a frame) in self-promoting chunks of 7; ``plain``, that
world in plain chunks of 4 (the host promotes the newest healthy frame at
each boundary; 4, the mono chunked world's size, as the JAX test calls 7
past this world's match-decay horizon for a fixed reference). All at
320x240, f = 260, a 0.5 m baseline, on ``tests/test_slam_e2e.py``'s small
configuration.

``Probe`` counts, on either package's ``CompiledSLAM``, what the run does
beyond its poses: the slots each device promotion minted, the landmarks the
boundary triangulation wrote over a slot a disparity landmark already held
(the double mint of the host promotion routes), and the BA solves that hit
``optimization.max_points``.
"""
from __future__ import annotations

import numpy as np

N_FRAMES, SEED, BASELINE, STEP, N_SPRITES = 48, 3, 0.54, 0.6, 1500
N_FEATURES, CHUNK, HEAVY = 2000, 8, 2
MAX_POINTS = 4096
BOOT_FRAMES = 6
DT = 0.1  # timestamp step: pair i at i * DT


def stereo_frames(n_frames: int = N_FRAMES):
    """Renders the world. Returns (lefts (n, H, W) f32, rights, K (3, 3) f32,
    T_gt (n, 4, 4) true T_w2c of the left camera)."""
    import bench

    lefts, rights, K, Ts = bench.synth_kitti_frames(n_frames=n_frames, seed=SEED, baseline=BASELINE, step=STEP,
                                                    n_sprites=N_SPRITES)
    return np.asarray(lefts), np.asarray(rights), K, np.asarray(Ts)


def config(Config, num_features: int = N_FEATURES, chunk_size: int = CHUNK):
    """bench_stereo_pipeline's configuration, in either package's ``Config``."""
    cfg = Config()
    cfg.camera.sensor_type = "stereo"
    cfg.feature.num_features = num_features
    cfg.tracking.keyframe_interval = 4
    cfg.tracking.chunk_size = chunk_size
    cfg.tracking.device_promotion = True
    cfg.tracking.heavy_boundary_every = HEAVY
    cfg.tracking.upload_f16 = True
    cfg.optimization.max_points = MAX_POINTS
    cfg.optimization.window_size = 16
    cfg.optimization.pose_bucket_floor = 32
    cfg.optimization.point_bucket_floor = 2048
    cfg.initialization.min_inliers = min(100, max(30, num_features // 20))
    return cfg


SMALL = {  # world: (seed, pairs, yaw a frame, chunk size, device promotion)
    "single": (6, 10, 0.004, 1, False),
    "promotion": (11, 17, 0.01, 7, True),
    "plain": (11, 17, 0.01, 4, False),
}
SMALL_W, SMALL_H, SMALL_F, SMALL_BASELINE = 320, 240, 260.0, 0.5


def small_frames(world: str, seed: int | None = None):
    """One of the small worlds (``seed``: its sprites drawn from another
    seed). Returns (lefts, rights, K (3, 3), T_gt)."""
    from render import camera_path, make_world, stereo_pair

    seed0, n, yaw, _, _ = SMALL[world]
    rng = np.random.default_rng(seed0 if seed is None else seed)
    sprites = make_world(rng)
    Ts = camera_path(n, step=0.3, yaw_rate=yaw)
    K = np.array([[SMALL_F, 0, SMALL_W / 2], [0, SMALL_F, SMALL_H / 2], [0, 0, 1.0]])
    pairs = [stereo_pair(sprites, T, K, SMALL_BASELINE, SMALL_W, SMALL_H) for T in Ts]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]), K, np.asarray(Ts)


def small_config(Config, world: str):
    """tests/test_slam_e2e.py's small configuration with the JAX stereo
    tests' changes for ``world``."""
    _, _, _, chunk, promo = SMALL[world]
    cfg = Config()
    cfg.feature.num_features = 384
    cfg.feature.num_pyramid_levels = 2
    cfg.feature.fast_threshold = 12.0
    cfg.feature.grid_cells = 4
    cfg.initialization.min_inliers = 30
    cfg.initialization.min_parallax_deg = 0.5
    cfg.initialization.essential_hypotheses = 128
    cfg.tracking.min_inliers = 10
    cfg.tracking.keyframe_interval = 2
    cfg.tracking.kf_min_matches = 25
    cfg.tracking.pnp_hypotheses = 128
    cfg.optimization.n_iter = 12
    cfg.optimization.window_size = 8
    cfg.local_mapping.max_neighbors = 2
    cfg.local_mapping.min_parallax_deg = 0.3
    cfg.camera.sensor_type = "stereo"
    cfg.tracking.chunk_size = chunk
    cfg.tracking.device_promotion = promo
    return cfg


def camera(PinholeCamera, lefts, K, baseline: float = BASELINE):
    return PinholeCamera(width=lefts[0].shape[1], height=lefts[0].shape[0], K=np.asarray(K, np.float64),
                         baseline=baseline)


def schedule(i: int, n_frames: int, chunk_size: int = CHUNK, heavy_every: int = HEAVY) -> tuple[int, int]:
    """The bench's warm-up end and timed-window end for a run whose first
    pair after the bootstrap is ``i``: (warm_end, n_end)."""
    n_end = n_frames - (n_frames - i) % chunk_size
    warm_end = min(i + 2 * max(chunk_size, 4) * heavy_every + 1, n_end - 2 * max(chunk_size, 8))
    return warm_end, n_end


def camera_centre(T_w2c) -> np.ndarray:
    return -T_w2c[:3, :3].T @ T_w2c[:3, 3]


def keyframe_errors(keyframes, Ts_gt) -> list[float]:
    """Each keyframe's camera-centre error (m, to the millimetre)."""
    return [round(float(np.linalg.norm(kf.camera_center - camera_centre(Ts_gt[int(round(kf.timestamp / DT))]))), 3)
            for kf in keyframes]


def _centres(ts, Ts, Ts_gt):
    idx = [int(round(t / DT)) for t in ts]
    return np.stack([camera_centre(T) for T in Ts]), np.stack([camera_centre(Ts_gt[j]) for j in idx])


def metric_ate(ate_rmse, ts, Ts, Ts_gt) -> tuple[float, float, float]:
    """(rmse m, % of the path, path m) of the camera centres against ground
    truth, without scale alignment, by the package's own ``ate_rmse``."""
    est, gt = _centres(ts, Ts, Ts_gt)
    rmse = float(ate_rmse(est, gt, align_scale=False)["rmse"])
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return rmse, 100.0 * rmse / max(path, 1e-9), path


def scale_fit(ate_rmse, ts, Ts, Ts_gt) -> tuple[float, float]:
    """(rmse m after a similarity alignment, the fitted scale): how much of
    the metric ATE is a scale error."""
    res = ate_rmse(*_centres(ts, Ts, Ts_gt), align_scale=True)
    return float(res["rmse"]), float(res["scale"])


class Probe:
    """Wraps ``slam``'s ``_adopt_device_keyframe``, ``_insert_triangulated``
    and its optimizer's ``_select_points`` (same names and arguments in both
    packages) to count:

    * ``minted``: per device promotion adopted, the slots the device minted
      (``rec.ref_tri``);
    * ``double_mints``: slots the boundary triangulation wrote into that
      already held a landmark (on a stereo system, the disparity landmark
      ``_create_stereo_points`` minted there a moment before, which stays in
      the map);
    * ``cap_hits`` / ``largest_solve``: BA solves handed more landmarks than
      ``optimization.max_points``, and the most any solve was handed;
    * ``largest_map``: the most landmarks the map held after an adoption or
      a boundary triangulation."""

    def __init__(self, slam):
        self.minted: list[int] = []
        self.double_mints = 0
        self.cap_hits = 0
        self.largest_solve = 0
        self.largest_map = 0
        adopt0, insert0 = slam._adopt_device_keyframe, slam._insert_triangulated
        select0 = slam.optimizer._select_points

        def adopt(out, rec, *a, **k):
            self.minted.append(int(np.asarray(rec.ref_tri).sum()))
            kf = adopt0(out, rec, *a, **k)
            self.largest_map = max(self.largest_map, slam.map.num_map_points())
            return kf

        def insert(kf, ref, ti, tri_mask, pts_np, good_np):
            slots = np.nonzero(np.asarray(good_np) & tri_mask)[0]
            self.double_mints += sum(kf.get_map_point(0, int(i)) is not None for i in slots)
            created = insert0(kf, ref, ti, tri_mask, pts_np, good_np)
            self.largest_map = max(self.largest_map, slam.map.num_map_points())
            return created

        def select(map_points, cap):
            n = len(map_points)
            self.largest_solve = max(self.largest_solve, n)
            self.cap_hits += n > cap
            return select0(map_points, cap)

        slam._adopt_device_keyframe, slam._insert_triangulated = adopt, insert
        slam.optimizer._select_points = select

    def summary(self) -> dict:
        return {"promotions_adopted": len(self.minted), "minted_per_promotion": self.minted,
                "minted_total": int(sum(self.minted)), "double_mints": self.double_mints,
                "ba_cap_hits": self.cap_hits, "largest_solve_landmarks": self.largest_solve,
                "largest_map": self.largest_map}


F7_PAIRS = (13, 14, 15, 16)  # the pairs before and at the keyframe where ROADMAP F7's failed runs break


def _host(x) -> np.ndarray:
    """A tensor or array of either package as a numpy array."""
    return np.asarray(x.detach().cpu()) if hasattr(x, "detach") else np.asarray(x)


class ChunkTrace:
    """Wraps ``slam._chunk`` (the self-promoting chunk; same arguments and
    outputs in both packages) to record, per tracked pair: the PnP inliers,
    the matches to the reference block, the guided arena pairs, the
    landmarks of the reference block the pair tracked against (the block at
    the chunk's start, or the one the chunk's last promotion before the pair
    made), the valid arena slots, whether the pair promoted and the slots it
    minted, and the camera-centre error of its tracked pose in the world the
    chunk tracked in. ``blocks`` keeps the reference block and arena the
    chunk holding ``F7_PAIRS[-1]`` received. The caller sets ``pair`` to the
    pair it is about to track; a chunk runs at its last pair. On the port,
    whose step solves each pose in ``solve_pose``, a row also holds the
    inliers the step's constant-velocity prediction held (``pred_inliers``),
    one host read a pair."""

    def __init__(self, slam, Ts_gt):
        self.pair = 0
        self.rows: dict[int, dict] = {}
        self.blocks: dict[str, np.ndarray] = {}
        self.pred: list[int] = []
        chunk0 = slam._chunk
        step = getattr(slam, "_step", None)
        if hasattr(step, "solve_pose"):
            from visual_slam_tpu_torch.ops.pnp import _reproj_err2

            solve0 = step.solve_pose

            def solve_pose(pts3d, xy_norm, pair_valid, T_pred, *a, **kw):
                err = _reproj_err2(T_pred[..., :3, :3], T_pred[..., :3, 3], pts3d, xy_norm)
                self.pred.append(int(((err < step.thresh * step.thresh) & pair_valid).sum()))
                return solve0(pts3d, xy_norm, pair_valid, T_pred, *a, **kw)

            step.solve_pose = solve_pose

        def chunk(state, *a, **kw):
            n = int(kw.get("n_valid") or len(a[2]))
            first = self.pair - n + 1
            block = int(_host(state.ref_has_landmark).sum())
            arena = int(_host(state.lm_valid).sum()) if state.lm_valid is not None else 0
            if first <= F7_PAIRS[-1] <= self.pair:
                self.blocks = {"ref_landmarks": _host(state.ref_landmarks), "ref_has": _host(state.ref_has_landmark),
                               "lm_pos": _host(state.lm_pos), "lm_valid": _host(state.lm_valid)}
            start = len(self.pred)
            res = chunk0(state, *a, **kw)
            pred = self.pred[start:]
            outs, recs = res[3], res[4]
            inl, matches = _host(outs.n_inliers), _host(outs.n_matches)
            guided, T = _host(outs.guided_valid).sum(-1), _host(outs.T_w2c)
            promoted, has, tri = _host(recs.promoted), _host(recs.ref_has).sum(-1), _host(recs.ref_tri).sum(-1)
            for j in range(n):
                k = first + j
                err = np.linalg.norm(camera_centre(np.asarray(T[j], np.float64)) - camera_centre(Ts_gt[k]))
                self.rows[k] = {"inliers": int(inl[j]), "ref_matches": int(matches[j]), "guided_pairs": int(guided[j]),
                                "ref_block_landmarks": block, "arena_valid": arena, "promoted": bool(promoted[j]),
                                "minted": int(tri[j]) if promoted[j] else 0, "centre_err_m": round(float(err), 3)}
                if j < len(pred):
                    self.rows[k]["pred_inliers"] = pred[j]
                if promoted[j]:
                    block = int(has[j])
            return res

        slam._chunk = chunk
