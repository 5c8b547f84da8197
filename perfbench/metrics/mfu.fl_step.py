"""The FL train step's share of the card's peak, in %: 6 x the
parameters that multiply x the tokens trained in the traced window, over
the window's wall x the peak of the configuration's precision
(``mfu_peak``: bf16, 989 TFLOP/s).

The parameters that multiply are counted here from the sizes: per RWKV6
layer the five time-mix projections and its output (6 d^2), the channel
mix's d x d_ff, d_ff x d and d x d; and the output head d x vocab (the
embedding is a lookup).  The recurrence's own FLOPs are not counted."""
from perfbench.lib import peaks


def multiplying_params(model: dict) -> int:
    d, ff, n = model["d_model"], model["d_ff"], model["n_layers"]
    vocab = ((model["vocab_size"] + 255) // 256) * 256
    return n * (7 * d * d + 2 * d * ff) + d * vocab


def read(data):
    if not data.get("rounds") or data["wall_s"] <= 0:
        return None
    peak = peaks.FLOPS[data["config"]["mfu_peak"]]
    flops = 6.0 * multiplying_params(data["config"]["model"]) * data["tokens"]
    return 100.0 * flops / (data["wall_s"] * peak)
