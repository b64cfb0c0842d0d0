"""2D feature/match overlays (host-side OpenCV/numpy; port of
``visual_slam_tpu.viz.feature_viz``).

Keypoint dots and stacked match visualization with gradient-coloured
lines, on numpy arrays. All functions RETURN the rendered image;
interactive display (``show=True``) requires OpenCV with GUI support.
Without OpenCV, keypoints are drawn as 3x3 squares and matches stack the
two images without lines.
"""
from __future__ import annotations

import numpy as np

try:
    import cv2  # type: ignore

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False


def _to_bgr(img: np.ndarray) -> np.ndarray:
    img8 = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    if img8.ndim == 2:
        return np.repeat(img8[:, :, None], 3, axis=2)
    return img8


def _hsv_colors(n: int) -> np.ndarray:
    """(n, 3) BGR gradient: an HSV hue sweep."""
    hues = np.linspace(0, 179, max(n, 1), dtype=np.uint8)
    out = np.zeros((n, 3), np.uint8)
    for i, h in enumerate(hues):
        if _HAS_CV2:
            out[i] = cv2.cvtColor(np.uint8([[[h, 255, 255]]]), cv2.COLOR_HSV2BGR)[0, 0]
        else:
            out[i] = (int(h) * 255 // 179, 128, 255 - int(h) * 255 // 179)
    return out


class FeatureVisualizer:
    def draw_keypoints(
        self, image: np.ndarray, xy: np.ndarray, valid: np.ndarray | None = None,
        radius: int = 2, color=(0, 0, 255), show: bool = False, window: str = "keypoints",
    ) -> np.ndarray:
        """Dots at the valid keypoints of ``xy`` on a BGR copy of ``image``."""
        out = _to_bgr(image).copy()
        xy = np.asarray(xy)
        mask = np.ones(len(xy), bool) if valid is None else np.asarray(valid)
        for x, y in xy[mask]:
            xi, yi = int(round(x)), int(round(y))
            if _HAS_CV2:
                cv2.circle(out, (xi, yi), radius, color, -1)
            elif 0 <= yi < out.shape[0] and 0 <= xi < out.shape[1]:
                out[max(yi - 1, 0) : yi + 2, max(xi - 1, 0) : xi + 2] = color[::-1]
        if show and _HAS_CV2:
            cv2.imshow(window, out)
            cv2.waitKey(1)
        return out

    def draw_matches(
        self, image1: np.ndarray, xy1: np.ndarray, image2: np.ndarray, xy2: np.ndarray,
        show: bool = False, window: str = "matches",
    ) -> np.ndarray:
        """Vertically-stacked pair with coloured correspondence lines. xy1/xy2
        are index-aligned matched coordinates."""
        im1, im2 = _to_bgr(image1), _to_bgr(image2)
        H1, W1 = im1.shape[:2]
        H2, W2 = im2.shape[:2]
        canvas = np.zeros((H1 + H2, max(W1, W2), 3), np.uint8)
        canvas[:H1, :W1] = im1
        canvas[H1 : H1 + H2, :W2] = im2
        xy1 = np.asarray(xy1)
        xy2 = np.asarray(xy2)
        colors = _hsv_colors(len(xy1))
        for i, ((x1, y1), (x2, y2)) in enumerate(zip(xy1, xy2)):
            c = tuple(int(v) for v in colors[i])
            p1 = (int(round(x1)), int(round(y1)))
            p2 = (int(round(x2)), int(round(y2)) + H1)
            if _HAS_CV2:
                cv2.line(canvas, p1, p2, c, 1, cv2.LINE_AA)
                cv2.circle(canvas, p1, 2, c, -1)
                cv2.circle(canvas, p2, 2, c, -1)
        if show and _HAS_CV2:
            cv2.imshow(window, canvas)
            cv2.waitKey(1)
        return canvas

    def draw_tracking_result(self, result, show: bool = False) -> np.ndarray:
        """Convenience overlay from a FeatureTrackingResult."""
        f1 = result.features1
        f2 = result.features2
        img1 = np.zeros((1, 1), np.uint8)
        return self.draw_matches(img1, result.kps1_matched, img1, result.kps2_matched, show=show)
