"""Wall ms a round that no span accounts for: each ``round`` span's
``dur_wall`` less those of its direct children (the spans whose
``parent`` is ``round``: the phases and the bucket dispatches), averaged
over the window's rounds."""


def read(data):
    spans = data.get("spans", ())
    if not any(s["kind"] == "phase" for s in spans):
        return None
    walls = {s["round"]: s["dur_wall"] for s in spans
             if s["kind"] == "round"}
    if not walls:
        return None
    for s in spans:
        if (s["kind"] != "round" and s["attrs"].get("parent") == "round"
                and s["round"] in walls):
            walls[s["round"]] -= s["dur_wall"]
    return 1000.0 * sum(walls.values()) / len(walls)
