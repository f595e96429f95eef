"""WARA PS telemetry adapter: best-track + GPS publishing (counterpart of
``beamforming_lk_tpu.app.waraps``).

Re-design of the reference's MQTT egress (``src/target_handler/
target_handler.cpp:172-222`` publishes the heading-rotated best track as a
GeoPoint to ``mqtts://broker.waraps.org:8883`` at 2 Hz;
``src/aw_control_unit/aw_control_unit.cpp:444-466`` publishes GPS/heading/
speed each second).  Degrades exactly like the reference (connect failure ->
run without telemetry, aw_control_unit.cpp:484-491): if paho-mqtt is absent
the adapter sinks NDJSON to a local file so the full publish path stays
testable offline.
"""

from __future__ import annotations

import json
import math
import time
from typing import Optional

import numpy as np

from beamforming_lk_tpu_torch.models.fusion import heading_rotation, position_to_gps


class TelemetrySink:
    """MQTT publisher with NDJSON-file fallback."""

    def __init__(
        self,
        broker: Optional[str] = None,
        port: int = 8883,
        username: Optional[str] = None,
        password: Optional[str] = None,
        fallback_path: Optional[str] = None,
    ):
        self._client = None
        self._file = None
        if broker:
            try:
                import paho.mqtt.client as mqtt  # optional dependency

                self._client = mqtt.Client()
                if username:
                    self._client.username_pw_set(username, password or "")
                self._client.connect(broker, port, keepalive=30)
                self._client.loop_start()
            except Exception as e:  # graceful degrade (aw_control_unit.cpp:484-491)
                print(f"WARA PS connection failed ({e}); telemetry disabled")
                self._client = None
        if self._client is None and fallback_path:
            self._file = open(fallback_path, "a")

    def publish(self, topic: str, payload: dict) -> None:
        msg = json.dumps(payload)
        if self._client is not None:
            self._client.publish(topic, msg)
        elif self._file is not None:
            self._file.write(json.dumps({"topic": topic, "payload": payload}) + "\n")
            self._file.flush()

    def close(self) -> None:
        if self._client is not None:
            self._client.loop_stop()
            self._client.disconnect()
        if self._file is not None:
            self._file.close()


class WaraPsPublisher:
    """Best-track GeoPoint publishing at a fixed interval
    (DisplayToWaraPS, target_handler.cpp:189-221)."""

    def __init__(
        self,
        sink: TelemetrySink,
        latitude: float,
        longitude: float,
        altitude: float = 0.0,
        heading: float = 0.0,
        interval: float = 0.5,  # 2 Hz (target_handler.h:132)
        topic: str = "sensor/position",
    ):
        self.sink = sink
        self.lat, self.lon, self.alt = latitude, longitude, altitude
        self.rotation = heading_rotation(heading)
        self.interval = interval
        self.topic = topic
        self._last_publish = -math.inf

    def maybe_publish(self, best_track, now: Optional[float] = None) -> bool:
        """Publish if a valid track exists and the interval elapsed."""
        now = time.monotonic() if now is None else now
        if best_track is None or now - self._last_publish < self.interval:
            return False
        out_position = self.rotation @ np.asarray(best_track.position, np.float64)
        geo = position_to_gps(out_position, self.lat, self.lon, self.alt)
        self.sink.publish(self.topic, geo)
        self._last_publish = now
        return True

    def update_origin(
        self,
        latitude: float,
        longitude: float,
        altitude: float = 0.0,
        heading: Optional[float] = None,
    ) -> None:
        """Re-reference published tracks to a live GPS fix (the reference
        reads gpsd each fusion pass, target_handler.cpp:196-206)."""
        self.lat, self.lon, self.alt = latitude, longitude, altitude
        if heading is not None:
            self.rotation = heading_rotation(heading)


class TelemetryHeartbeat:
    """Periodic own-position/heading/speed publish — the reference's 1 Hz
    telemetry thread (``publishData``, aw_control_unit.cpp:444-466)."""

    def __init__(
        self,
        sink: TelemetrySink,
        interval: float = 1.0,
        topic: str = "sensor/telemetry",
    ):
        self.sink = sink
        self.interval = interval
        self.topic = topic
        self._last_publish = -math.inf

    def maybe_publish(self, fix, now: Optional[float] = None) -> bool:
        """Publish the latest GPS fix (io.gps.GpsFix or None) if due."""
        now = time.monotonic() if now is None else now
        if fix is None or now - self._last_publish < self.interval:
            return False
        self.sink.publish(
            self.topic,
            {
                "latitude": fix.latitude,
                "longitude": fix.longitude,
                "altitude": fix.altitude,
                "heading": fix.track,
                "speed": fix.speed,
                "type": "GeoPoint",
            },
        )
        self._last_publish = now
        return True
