"""The LM substrate: the counterpart of :mod:`repro.models` (serving,
training and the optimiser)."""
