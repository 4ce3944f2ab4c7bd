"""``peak_device_gib``: ``torch.cuda.max_memory_allocated()`` over the
window, reset at its start, on the fullest card."""


def read(window):
    return window["peak_bytes"] / float(1 << 30)
