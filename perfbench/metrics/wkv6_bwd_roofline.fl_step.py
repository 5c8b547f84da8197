"""The RWKV6 recurrence's backward kernels' share of their roofline in
the FL train step, in %.

Per call, at (B, H, T, D) = (rows a replica, d / 64, seq_len, 64) in
bf16: r, k, v, the decay and the output's gradient read once and the
gradients of r, k, v and the decay written once (9 x B H T D x 2 bytes,
plus u and its gradient), and about 14 D^2 FLOPs a (b, h, t) (twice the
forward's).  Calls = replicas x local steps x layers a round.  The time
is the device time of every kernel whose name holds ``wkv6_bwd``."""
from perfbench.lib import peaks
from perfbench.lib.profile import kernel_seconds


def per_call(b, h, t, d):
    elems = b * h * t * d
    return 14.0 * b * h * t * d * d, 9 * elems * 2 + 2 * h * d * 2


def read(data):
    prof = data.get("profile")
    if not prof:
        return None
    secs, n = kernel_seconds(prof["events"], lambda s: "wkv6_bwd" in s)
    if not n:
        return None
    t, m = data["workload"]["traffic"], data["config"]["model"]
    heads = max(1, m["d_model"] // 64)
    flops, nbytes = per_call(t["global_batch"] // t["n_replicas"], heads,
                             t["seq_len"], m["d_model"] // heads)
    calls = (t["n_replicas"] * t["h_local"] * m["n_layers"]
             * len(data["profiled"]))
    return 100.0 * calls * peaks.roofline_s(flops, nbytes, "bfloat16") / secs
