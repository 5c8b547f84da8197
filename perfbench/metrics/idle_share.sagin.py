"""The card's idle share of the traced window: 1 - (the union of its
busy intervals, kernels, copies and sets, from ``torch.profiler``) / (the
window's length)."""


def read(data):
    prof = data.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 1.0 - prof["busy_s"] / prof["window_s"]
