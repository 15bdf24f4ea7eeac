"""Host wall of the device decode, per query:
`scan_stage_seconds{stage="device_decode"}` over the window
(`ops/device_decode.py`: upload, decode, partials, download), divided
by the queries.  The seconds are summed over concurrent segments."""


def read(r):
    if not r.stages.get("device_decode_calls") or not r.queries:
        return None
    return r.stages.get("device_decode_s", 0.0) * 1e3 / r.queries
