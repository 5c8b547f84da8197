"""Host time of a round outside its bucket dispatches, in ms: the round
loop and the NumPy control plane (plan, handover schedule, latency
model, pool moves), the evaluation and the bookkeeping.  The benchmark's
clock around each ``RegionTrainer.step`` minus that round's
``bucket_dispatch`` spans (the program's tracer, each fenced by a
synchronize), averaged over the window's rounds."""


def read(data):
    spans = [s for s in data.get("spans", ())
             if s["kind"] == "bucket_dispatch"]
    if not spans or not data.get("rounds"):
        return None
    per = {}
    for s in spans:
        per[s["round"]] = per.get(s["round"], 0.0) + s["dur_wall"]
    rest = [(r["t1"] - r["t0"]) - per.get(r["round"], 0.0)
            for r in data["rounds"]]
    return 1000.0 * sum(rest) / len(rest)
