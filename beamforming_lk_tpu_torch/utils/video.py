"""Optional video recording / live display (cv2-gated).

The reference records the UI to AVI on the ``r`` key and shows frames with
``cv::imshow`` (``src/aw_control_unit/aw_control_unit.cpp:150-162, 415``).
Here both are thin optional sinks over the headless RGB frame path — the
framework never requires OpenCV.

A copy of ``beamforming_lk_tpu.utils.video`` (numpy, the standard
library and an optional cv2), kept in the port so that the port loads no
module of the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def has_cv2() -> bool:
    try:
        import cv2  # noqa: F401

        return True
    except ImportError:
        return False


class VideoRecorder:
    """AVI sink for RGB frames (startRecording/stopRecording analog)."""

    def __init__(self, path: str, fps: float = 60.0):
        if not has_cv2():
            raise RuntimeError("cv2 unavailable; use PNG frame output instead")
        self.path = path
        self.fps = fps
        self._writer = None

    def write(self, frame: np.ndarray) -> None:
        import cv2

        if self._writer is None:
            h, w = frame.shape[:2]
            self._writer = cv2.VideoWriter(
                self.path, cv2.VideoWriter_fourcc(*"MJPG"), self.fps, (w, h)
            )
        self._writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class CameraSource:
    """Webcam frames as RGB arrays (the reference's ``--camera INDEX``
    opens ``cv::VideoCapture`` and composites the heatmap onto the feed).

    Returns ``None`` when no frame is available — callers fall back to the
    plain heatmap, mirroring the reference's camera-load degrade path.
    """

    def __init__(self, index: int = 0):
        if not has_cv2():
            raise RuntimeError("cv2 unavailable for camera capture")
        import cv2

        self._cap = cv2.VideoCapture(index)
        if not self._cap.isOpened():
            raise RuntimeError(f"camera {index} failed to open")

    def read(self) -> Optional[np.ndarray]:
        import cv2

        ok, frame = self._cap.read()
        if not ok:
            return None
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    def close(self) -> None:
        self._cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class LiveDisplay:
    """cv2 window showing frames; returns pressed key (the UI loop's
    ``waitKey(1)``; 'q' quits in the reference)."""

    def __init__(self, title: str = "beamforming_lk_tpu"):
        if not has_cv2():
            raise RuntimeError("cv2 unavailable for display")
        self.title = title
        self._clicks: list = []
        self._mouse_wired = False

    def _on_mouse(self, event, x, y, *_):
        import cv2

        if event == cv2.EVENT_LBUTTONDOWN:
            self._clicks.append((y, x))  # (row, col)

    def pop_clicks(self):
        """Drain queued left-clicks as (row, col) frame pixels — the
        reference steers MISO by click (aw_control_unit.cpp:30-47)."""
        clicks, self._clicks = self._clicks, []
        return clicks

    def show(self, frame: np.ndarray) -> Optional[str]:
        import cv2

        cv2.imshow(self.title, cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        if not self._mouse_wired:
            cv2.setMouseCallback(self.title, self._on_mouse)
            self._mouse_wired = True
        key = cv2.waitKey(1) & 0xFF
        return chr(key) if key != 255 else None

    def close(self) -> None:
        import cv2

        cv2.destroyWindow(self.title)
