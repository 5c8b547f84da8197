"""The paper's own FL payloads (Section VI-A): small CNNs + VGG-11.

These are not ModelConfigs (they are vision CNNs, see repro.models.cnn);
this module records their metadata for the latency model.
"""
PAPER_MODELS = {
    "mnist": {"model": "cnn-2conv-2fc", "dataset": "mnist"},
    "fmnist": {"model": "cnn-2conv-1fc", "dataset": "fmnist"},
    "cifar10": {"model": "vgg11", "dataset": "cifar10"},
}
