"""scene_p90_ms: the 90th percentile of the window's scene latencies, submit of the
frame to the return of its scene."""
from perfbench.harness.stats import percentile


def read(run):
    lat = run.window.get("latencies_s")
    return 1e3 * percentile(lat, 90) if lat else None
