"""The RWKV6 recurrence's forward kernels' share of their roofline in the
FL train step, in %.

The work the step needs is one forward a layer a local step: per call,
at (B, H, T, D) = (rows a replica, d / 64, seq_len, 64) in bf16, r, k, v
and the decay read once and the output written once (5 x B H T D x 2
bytes, plus u), and per (b, h, t) about 7 D^2 FLOPs (the outer product
k v^T, the decay of the state, the bonus, the read-out r (S + u k v^T)).
Calls = replicas x local steps x layers a round; a forward recomputed
under remat is time without new work.  The time is the device time of
every kernel whose name holds ``wkv6`` and not ``wkv6_bwd``."""
from perfbench.lib import peaks
from perfbench.lib.profile import kernel_seconds


def per_call(b, h, t, d):
    elems = b * h * t * d
    return 7.0 * b * h * t * d * d, 5 * elems * 2 + h * d * 2


def read(data):
    prof = data.get("profile")
    if not prof:
        return None
    secs, n = kernel_seconds(
        prof["events"], lambda s: "wkv6" in s and "wkv6_bwd" not in s)
    if not n:
        return None
    t, m = data["workload"]["traffic"], data["config"]["model"]
    heads = max(1, m["d_model"] // 64)
    flops, nbytes = per_call(t["global_batch"] // t["n_replicas"], heads,
                             t["seq_len"], m["d_model"] // heads)
    calls = (t["n_replicas"] * t["h_local"] * m["n_layers"]
             * len(data["profiled"]))
    return 100.0 * calls * peaks.roofline_s(flops, nbytes, "bfloat16") / secs
