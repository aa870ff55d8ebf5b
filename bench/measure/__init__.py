"""Frozen measuring pieces: the device-side data, the trace, the peaks."""
