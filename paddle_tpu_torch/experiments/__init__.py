"""Experiments of the port: kernels the training path does not run,
kept with the entry point that measures them (the counterpart of the
reference's ``tools/experiments``)."""
