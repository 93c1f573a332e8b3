"""Launchers: the training loop (``launch.train``)."""
