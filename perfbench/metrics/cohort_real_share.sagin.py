"""The share of the trained layout that is real samples: ``real`` over
``layout`` summed over the window's ``bucket_dispatch`` spans (the
cohort engine pads every bucket to its width and client grid)."""


def read(data):
    spans = [s for s in data.get("spans", ())
             if s["kind"] == "bucket_dispatch"]
    layout = sum(s["attrs"]["layout"] for s in spans)
    if not layout:
        return None
    return sum(s["attrs"]["real"] for s in spans) / layout
