"""Published peaks by the name torch.cuda.get_device_name() gives (NVIDIA's
H100 SXM data sheet, dense, at the full 700 W power limit): HBM bytes a
second, and float32 operations a second outside the tensor cores. A card
missing here has no roofline: its readers return nothing."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_s": 3.35e12, "f32_flop_s": 67e12},
}


def least_seconds(device_name, nbytes, flops):
    """The least time a kernel that moves `nbytes` and does `flops`
    float32 operations could take on the card, or None for a card
    without published peaks."""
    p = PEAKS.get(device_name)
    if p is None:
        return None
    return max(nbytes / p["bytes_s"], flops / p["f32_flop_s"])
