"""gpsd client: live position/heading/speed for geo-referencing.

The reference opens gpsd at ``localhost:2947`` through libgps and degrades
gracefully if unavailable (``src/aw_control_unit/aw_control_unit.cpp:468-482``),
then reads position/heading/speed for the 1 Hz telemetry publish
(``aw_control_unit.cpp:444-466``) and for geo-referencing the best track
(``src/target_handler/target_handler.cpp:196-206``).  gpsd natively speaks
newline-delimited JSON over TCP, so the framework needs no libgps: this
is a small non-blocking reader of ``TPV`` reports.

Protocol: on connect the daemon sends a ``VERSION`` object; the client sends
``?WATCH={"enable":true,"json":true}`` and then receives a stream of
``TPV``/``SKY``/... objects.  ``TPV`` carries ``mode`` (0/1 = no fix,
2 = 2D, 3 = 3D), ``lat``/``lon``/``alt`` degrees/metres, ``track`` (course
over ground, degrees true) and ``speed`` (m/s).

A copy of ``beamforming_lk_tpu.io.gps`` (numpy and the standard library
only), kept in the port so that the port loads no module of the JAX
package.
"""

from __future__ import annotations

import json
import socket
import sys
from typing import NamedTuple, Optional


class GpsFix(NamedTuple):
    latitude: float
    longitude: float
    altitude: float
    track: float      # heading / course over ground [deg]
    speed: float      # [m/s]
    mode: int         # 0/1 none, 2 = 2D, 3 = 3D fix


WATCH_COMMAND = b'?WATCH={"enable":true,"json":true}\n'


class GpsdClient:
    """Non-blocking gpsd reader keeping the most recent fix.

    Construct via :meth:`connect`, which returns ``None`` instead of raising
    when the daemon is unreachable — the reference's degrade path
    (``aw_control_unit.cpp:473-482``: "GPS connection failed" → continue
    without GPS).
    """

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""
        self._fix: Optional[GpsFix] = None

    @classmethod
    def connect(
        cls, host: str = "127.0.0.1", port: int = 2947, timeout: float = 1.0
    ) -> Optional["GpsdClient"]:
        try:
            sock = socket.create_connection((host, port), timeout=timeout)
            sock.sendall(WATCH_COMMAND)
            sock.setblocking(False)
            return cls(sock)
        except OSError as e:
            print(f"GPS connection failed ({e}); continuing without GPS",
                  file=sys.stderr)
            return None

    def poll(self) -> Optional[GpsFix]:
        """Drain pending reports; return the latest fix (sticky: the last
        known fix is returned until a newer one arrives, ``None`` until the
        first fix with mode >= 2)."""
        while True:
            try:
                chunk = self._sock.recv(65536)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                break
            if not chunk:  # daemon went away; keep last fix
                break
            self._buf += chunk
        while b"\n" in self._buf:
            line, self._buf = self._buf.split(b"\n", 1)
            self._handle(line)
        return self._fix

    def _handle(self, line: bytes) -> None:
        try:
            obj = json.loads(line)
        except (ValueError, UnicodeDecodeError):
            return
        if obj.get("class") != "TPV":
            return
        mode = int(obj.get("mode", 0))
        if mode < 2 or "lat" not in obj or "lon" not in obj:
            return
        self._fix = GpsFix(
            latitude=float(obj["lat"]),
            longitude=float(obj["lon"]),
            altitude=float(obj.get("alt", obj.get("altHAE", 0.0)) or 0.0),
            track=float(obj.get("track", 0.0) or 0.0),
            speed=float(obj.get("speed", 0.0) or 0.0),
            mode=mode,
        )

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
