"""device_bytes_per_text_byte: the device's peak of allocated bytes in
the window (reset where it opens) per byte of text."""


def read(rec: dict):
    if not rec.get("peak_window_bytes"):
        return None
    return rec["peak_window_bytes"] / rec["text_bytes"]
