"""``fedavg_agg``'s share of its roofline in the SAGIN round, in %.

The bound of a round's aggregate is its bytes at the card's HBM rate:
every real client's float32 model read once and the global model written
once, (clients + 1) x VGG-11's parameters x 4 bytes (padding clients of
the layout are not work the aggregate needs).  The time is the device
time of every kernel named ``fedavg_agg`` in the profiled rounds."""
from perfbench.lib import peaks
from perfbench.lib.profile import kernel_seconds


def read(data):
    prof = data.get("profile")
    if not prof:
        return None
    secs, n = kernel_seconds(prof["events"], lambda s: "fedavg_agg" in s)
    if not n:
        return None
    nbytes = sum((r["clients"] + 1) * data["n_params"] * 4
                 for r in data["profiled"])
    return 100.0 * peaks.roofline_s(0.0, nbytes, "float32") / secs
