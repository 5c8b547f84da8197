"""``fedavg_agg``'s share of its roofline in the FL train step, in %.

The bound of a round's aggregate is its bytes at the card's HBM rate:
the replicas' stacks read once and the mean written once, in the
aggregate's type, (replicas + 1) x the model's parameters x its size
(4 bytes for float32).  The time is the device time of every kernel named
``fedavg_agg`` in the profiled rounds."""
from perfbench.lib import peaks
from perfbench.lib.profile import kernel_seconds

ITEM = {"float32": 4, "bfloat16": 2}


def read(data):
    prof = data.get("profile")
    if not prof:
        return None
    secs, n = kernel_seconds(prof["events"], lambda s: "fedavg_agg" in s)
    if not n:
        return None
    t = data["workload"]["traffic"]
    per_round = ((t["n_replicas"] + 1) * data["config"]["param_count"]
                 * ITEM[t["agg_dtype"]])
    nbytes = per_round * len(data["profiled"])
    return 100.0 * peaks.roofline_s(0.0, nbytes, "float32") / secs
