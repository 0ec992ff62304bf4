"""The share of the traced window's device busy time spent in kernels
launched inside ``layers._expert_ffn`` (the routed experts' products)."""
from harness.readers import label_share

LABELS = {"pb.expert_ffn": ("repro_torch.models.layers", "_expert_ffn")}


def read(run):
    return label_share(run, "pb.expert_ffn")
