"""Bytes copied from the host to the card, per query:
`horaedb_h2d_bytes_total` over the window (`ops/encode.py::to_device`,
an exact count), divided by the queries."""


def read(r):
    if not r.queries:
        return None
    return r.counters.get("horaedb_h2d_bytes_total", 0) / r.queries
