"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name`` gives (NVIDIA's data sheet, SXM part, at
its full power limit of 700 W).  Every kernel the benchmark counts reads
a table of 4 or 8 bytes per two operations, so memory bandwidth is the
one peak its rooflines need."""

import torch

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peak(device, key: str):
    """The peak ``key`` of the card ``device`` runs on, or None (a CPU, or
    a card not in the table)."""
    if torch.device(device).type != "cuda":
        return None
    return PEAKS.get(torch.cuda.get_device_name(0), {}).get(key)
