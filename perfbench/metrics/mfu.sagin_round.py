"""The SAGIN round's share of the card's peak, in %: the model FLOPs of
the samples the profiled rounds train over those rounds' walls (they run
unfenced, as the untraced window does).

VGG-11's forward at 32 x 32 x 3 is counted from its shapes here (2 x the
multiply-adds of its eight 3 x 3 convolutions and its dense layer:
305.54 MFLOP an image); training is 3 x that.  The samples are the real
ones, H x B a node by the pipeline's sizing rule, not the padded layout.
The peak is that of the precision the configuration states
(``mfu_peak``)."""
from perfbench.lib import peaks

LAYOUT = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]


def forward_flops(h=32, w=32, c=3, n_classes=10) -> float:
    flops, cin = 0.0, c
    for v in LAYOUT:
        if v == "M":
            h, w = h // 2, w // 2
        else:
            flops += 2.0 * h * w * 9 * cin * v
            cin = v
    return flops + 2.0 * h * w * cin * n_classes


def read(data):
    rounds = data.get("profiled")
    wall = sum(r["t1"] - r["t0"] for r in rounds or ())
    if not rounds or wall <= 0:
        return None
    samples = sum(r["real_samples"] for r in rounds)
    peak = peaks.FLOPS[data["config"]["mfu_peak"]]
    return 100.0 * 3 * forward_flops() * samples / (wall * peak)
