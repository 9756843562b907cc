"""Distributed pieces of the port that run on one process (the
checkpoint layer); the multi-process collectives are not ported."""
