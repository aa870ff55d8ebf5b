"""The LM substrate: the counterpart of :mod:`repro.models` (serving and
the forward pass; training is not ported yet)."""
