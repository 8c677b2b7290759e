"""service_ms_p50: the median, over the traced window's requests, of the
host time from the call into ``InferenceServer.predict`` to its return
(service without the queue). Moves request_p95_ms."""
import statistics


def read(rec):
    s = rec.get("service_s")
    return None if not s else 1e3 * statistics.median(s)
