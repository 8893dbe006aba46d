"""The 95th percentile (ms) of the window's frame times, from the call of
``process_frame`` to its returned answer: the streaming tail, read where
the card idles most of the window and the host paces the tail."""

import statistics


def read(record):
    lat = record["window"].get("latencies")
    if not lat or len(lat) < 20:
        return None
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]
