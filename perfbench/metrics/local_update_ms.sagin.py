"""Time of a round's bucket dispatches, in ms: each bucket's host-to-
device copy and its vmapped local SGD (``fl/client.py``), fenced by a
synchronize (``ObsConfig(device_timing=True)``), summed over the round's
``bucket_dispatch`` spans and averaged over the window's rounds."""


def read(data):
    spans = [s for s in data.get("spans", ())
             if s["kind"] == "bucket_dispatch"]
    if not spans or not data.get("rounds"):
        return None
    return 1000.0 * sum(s["dur_wall"] for s in spans) / len(data["rounds"])
