"""Clock fusion between LiDAR, INS and wall-clock time bases.

Capability parity with the reference's TimeSolver (reference
TimeSolver.cxx:20-49), re-specified on absolute GPS time:

  * INS messages carry (GPS week, milliseconds-into-week) plus a finer
    position time (week_pos, seconds_pos); the fused INS timestamp applies
    the fine-time correction exactly as the reference does
    (TimeSolver.cxx:27-30: p + offset + (insTime - p)).
  * HDL data packets carry only microseconds-into-the-current-hour
    (uint32 at byte 1200); resolving them to absolute time needs an hour
    base plus wrap detection when the counter resets
    (TimeSolver.cxx:43-45).

Unlike the reference — which anchors both to the *local* wall clock at
first receipt and hardcodes GMT+8 (type_defs.cxx:69-72) — absolute time
here is true GPS time converted to Unix microseconds, and the wall-clock
anchor is an explicit, optional argument (needed only for live capture
where the sensor's hour base is unknown).

All host-side, pure numpy/python: this runs once per packet, never on the
device.
"""

from __future__ import annotations

from typing import Optional

# GPS epoch (1980-01-06 00:00:00 UTC) in Unix microseconds.
GPS_EPOCH_UNIX_US = 315_964_800_000_000
WEEK_US = 7 * 24 * 3600 * 1_000_000
HOUR_US = 3600 * 1_000_000


def ins_timestamp_us(week_number: int, milliseconds: int,
                     week_number_pos: Optional[int] = None,
                     seconds_pos: Optional[float] = None) -> int:
    """INSPVA (week, ms[, fine pos time]) -> Unix microseconds.

    When the fine position time is present, it *replaces* the coarse one —
    algebraically what TimeSolver.cxx:27-30 computes with its
    p + (insTime - p) correction.
    """
    coarse = GPS_EPOCH_UNIX_US + week_number * WEEK_US + int(milliseconds) * 1000
    if week_number_pos is None or seconds_pos is None or seconds_pos < 0:
        return coarse
    fine = (GPS_EPOCH_UNIX_US + int(week_number_pos) * WEEK_US
            + int(round(float(seconds_pos) * 1e6)))
    return fine


class HdlClock:
    """Resolve HDL µs-into-hour stamps to absolute Unix microseconds.

    The hour base is taken from the first reference time provided (e.g. the
    pcap record timestamp offline, or the wall clock live), then advanced on
    counter wrap (reference TimeSolver.cxx:33-49).
    """

    def __init__(self):
        self._hour_base_us: Optional[int] = None
        self._last_report: int = 0

    def resolve(self, us_into_hour: int, ref_time_us: Optional[int] = None) -> int:
        us_into_hour = int(us_into_hour)
        if self._hour_base_us is None:
            if ref_time_us is None:
                raise ValueError("first HDL stamp needs a reference time "
                                 "to establish the hour base")
            # Choose the hour base so the resolved time lands nearest ref.
            base = (ref_time_us - us_into_hour)
            # Snap to the hour grid of ref_time to mimic the sensor's top-of-
            # hour counter reset without assuming clock alignment.
            self._hour_base_us = base
        elif us_into_hour < self._last_report:
            self._hour_base_us += HOUR_US          # counter wrapped: new hour
        self._last_report = us_into_hour
        return self._hour_base_us + us_into_hour

    @property
    def grounded(self) -> bool:
        return self._hour_base_us is not None

    def resolve_batch(self, us_array, ref_time_us: Optional[int] = None):
        """Vectorized `resolve` over an ordered stamp array (numpy int64) —
        replaces a per-packet Python loop on the ingest path.  Counter
        wraps within the array advance the hour base cumulatively."""
        import numpy as np

        us = np.asarray(us_array, np.int64)
        if len(us) == 0:
            return np.empty(0, np.int64)
        if self._hour_base_us is None:
            if ref_time_us is None:
                raise ValueError("first HDL stamp needs a reference time "
                                 "to establish the hour base")
            self._hour_base_us = int(ref_time_us) - int(us[0])
            self._last_report = int(us[0])
        prev = np.concatenate([[self._last_report], us[:-1]])
        wraps = np.cumsum(us < prev)
        out = self._hour_base_us + us + wraps * HOUR_US
        self._hour_base_us += int(wraps[-1]) * HOUR_US
        self._last_report = int(us[-1])
        return out

    def maybe_ground(self, us_into_hour: int, utc_us: int,
                     tolerance_us: int = 50_000) -> bool:
        """Ground only when it matters: the first time, or when the implied
        hour base drifted beyond `tolerance_us` from the current one.
        NMEA RMC time is quantized to ~10 ms, so re-grounding on every
        position packet would jitter resolved stamps; this keeps the base
        stable once it is within tolerance.  Returns True if grounded."""
        new_base = int(utc_us) - int(us_into_hour)
        if self._hour_base_us is not None and \
                abs(new_base - self._hour_base_us) <= tolerance_us:
            return False
        self.ground(us_into_hour, utc_us)
        return True

    def ground(self, us_into_hour: int, utc_us: int) -> int:
        """Pin the hour base to GPS truth: the sensor's position packet
        pairs its µs-into-hour counter with an NMEA UTC fix, making the
        base exact instead of inferred from pcap/wall-clock reference
        time (io.packets.unpack_position_packet).  Returns the correction
        applied in µs (0 on first grounding)."""
        us_into_hour = int(us_into_hour)
        new_base = int(utc_us) - us_into_hour
        old = self._hour_base_us
        self._hour_base_us = new_base
        self._last_report = us_into_hour
        return 0 if old is None else new_base - old


def resolve_hour_stamps(gps_us, hour_base_us: int,
                        ref_us: Optional[int] = None):
    """Offline bulk resolution: ordered µs-into-hour stamps → absolute µs
    against a grounded hour base, handling counter wraps within the array.

    `ref_us` (e.g. the first pcap record capture time) disambiguates which
    hour the FIRST stamp belongs to when the grounding packet arrived in a
    later hour than the start of the recording."""
    import numpy as np

    us = np.asarray(gps_us, np.int64)
    if len(us) == 0:
        return np.empty(0, np.int64)
    wraps = np.concatenate([[0], np.cumsum(us[1:] < us[:-1])])
    out = int(hour_base_us) + us + wraps * HOUR_US
    if ref_us is not None:
        k = int(round((int(ref_us) - int(out[0])) / HOUR_US))
        out = out + k * HOUR_US
    return out
